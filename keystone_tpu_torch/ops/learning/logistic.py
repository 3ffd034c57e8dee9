"""Logistic / softmax regression by L-BFGS.

Port of ``keystone_tpu/ops/learning/logistic.py`` (reference:
nodes/learning/LogisticRegressionModel.scala:19-94). The multinomial
cross-entropy objective runs through the same L-BFGS loop as the
least-squares solver (``lbfgs.minimize_lbfgs``, ``optax.lbfgs``'s
algorithm), with its gradient in closed form:
``Xᵀ(softmax(XW) − onehot)/n + λW``, both products through the solver
binding at the mode's precision.

Over the fit's mesh (``partitioner.fit_mesh``), with several row shards,
the objective and its gradient are per-shard partials summed across
shards by ``allreduce_sum``.

The fitted transformer maps features to per-class scores (logits); argmax
matches the reference's classify-by-max behavior. It carries the run's
``lbfgs`` record.
"""

from __future__ import annotations

import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
from ...parallel.partitioner import fit_mesh
from ...workflow.pipeline import LabelEstimator
from .block import _as_array_dataset
from .lbfgs import minimize_lbfgs
from .linear import LinearMapper


class LogisticRegressionEstimator(LabelEstimator):
    """Multinomial logistic regression; labels are int class ids. Fits on
    ``device`` (default CUDA)."""

    def __init__(self, num_classes: int, reg: float = 0.0,
                 num_iterations: int = 100, memory_size: int = 10,
                 tol: float = 1e-6, device: DeviceLike = None):
        self.num_classes = num_classes
        self.reg = reg
        self.num_iterations = num_iterations
        self.memory_size = memory_size
        self.tol = tol
        self.device = device

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label, out_width=self.num_classes)

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        n = features.num_examples
        x = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data.reshape(-1)[:n].to(device=device, dtype=torch.long)
        onehot = torch.nn.functional.one_hot(y, self.num_classes).to(torch.float32)
        reg = float(self.reg)
        mesh = linalg._row_mesh(x, fit_mesh(self))
        # Row shards (one without a mesh). A zero pad row carries a zero
        # one-hot row, so ``valid`` (its row sum, exactly 1.0 on a real
        # row) drops it from the objective and the gradient.
        xs, ys = linalg._row_shards(x, mesh), linalg._row_shards(y, mesh)
        hs = linalg._row_shards(onehot, mesh)

        def value_and_grad(w):
            values, grads = [], []
            for xi, yi, hi, wi in zip(xs, ys, hs, linalg._bcast(w, mesh)):
                logp = torch.log_softmax(linalg.mm(xi, wi), dim=-1)
                valid = hi.sum(dim=1)
                values.append(-torch.sum(logp[torch.arange(len(yi), device=yi.device), yi] * valid))
                grads.append(linalg.mm_t(xi, torch.exp(logp) * valid[:, None] - hi))
            value = linalg._reduce(values, mesh) / n + 0.5 * reg * torch.sum(w * w)
            return value, linalg._reduce(grads, mesh) / n + reg * w

        w0 = torch.zeros(x.shape[1], self.num_classes, dtype=torch.float32, device=device)
        w, info = minimize_lbfgs(value_and_grad, w0, self.num_iterations, self.memory_size, self.tol)
        mapper = LinearMapper(w)
        mapper.lbfgs = info
        return mapper


__all__ = ["LogisticRegressionEstimator"]
