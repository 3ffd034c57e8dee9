"""Logistic / softmax regression by L-BFGS.

Port of ``keystone_tpu/ops/learning/logistic.py`` (reference:
nodes/learning/LogisticRegressionModel.scala:19-94). The multinomial
cross-entropy objective runs through the same L-BFGS loop as the
least-squares solver (``lbfgs.minimize_lbfgs``, ``optax.lbfgs``'s
algorithm), with its gradient in closed form:
``Xᵀ(softmax(XW) − onehot)/n + λW``, both products through the solver
binding at the mode's precision.

The fitted transformer maps features to per-class scores (logits); argmax
matches the reference's classify-by-max behavior. It carries the run's
``lbfgs`` record.
"""

from __future__ import annotations

import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
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

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        n = features.num_examples
        x = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data.reshape(-1)[:n].to(device=device, dtype=torch.long)
        onehot = torch.nn.functional.one_hot(y, self.num_classes).to(torch.float32)
        rows = torch.arange(n, device=device)
        reg = float(self.reg)

        def value_and_grad(w):
            logits = linalg.mm(x, w)
            logp = torch.log_softmax(logits, dim=-1)
            value = -torch.sum(logp[rows, y]) / n + 0.5 * reg * torch.sum(w * w)
            resid = torch.exp(logp) - onehot
            return value, linalg.mm_t(x, resid) / n + reg * w

        w0 = torch.zeros(x.shape[1], self.num_classes, dtype=torch.float32, device=device)
        w, info = minimize_lbfgs(value_and_grad, w0, self.num_iterations, self.memory_size, self.tol)
        mapper = LinearMapper(w)
        mapper.lbfgs = info
        return mapper


__all__ = ["LogisticRegressionEstimator"]
