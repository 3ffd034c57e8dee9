"""Exact linear solvers: LinearMapper / LinearMapEstimator /
LocalLeastSquaresEstimator / SparseLinearMapper.

Port of ``keystone_tpu/ops/learning/linear.py`` (reference:
nodes/learning/LinearMapper.scala:18-161,
nodes/learning/LocalLeastSquaresEstimator.scala:16-61,
nodes/learning/SparseLinearMapper.scala:13-50). Fitting centers features and
labels, solves (AᵀA + λI) X = AᵀB on the centered data, and the model
applies ``(x − μ_A)·X + μ_B``.

``LinearMapEstimator`` has both fits of the streaming protocol: ``fit``
through ``linalg.centered_solve_refined`` (under the default ``refine``
precision mode a bf16 Gram on the card, two IEEE fp32 refinement steps
and the divergence guard), and ``fit_stream``, which
accumulates the same normal equations chunk by chunk — the exact
streamed-versus-materialized parity case.

``LocalLeastSquaresEstimator`` is a host numpy lstsq/solve, as in the
JAX package, whose model lands on the requested device.
``SparseLinearMapper`` applies a dense model to host CSR rows (densified
on the weights' device) or to dense rows.

``LinearMapEstimator.fit`` runs over the fit's mesh
(``partitioner.fit_mesh``: the pinned partition decision, else the
ambient mesh): with several row shards the Gram, column sums and
refinement residuals are per-shard partials summed across shards.

``LinearMapEstimator`` carries the refit state contract
(``refit/state.py``, ``GramStreamStateMixin``): ``fit_stream(stream,
state=None)`` and ``finish_from_state``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
from ...parallel.partitioner import fit_mesh
from ...refit.state import GramStreamStateMixin
from ...workflow.pipeline import BatchTransformer, LabelEstimator
from .block import _as_array_dataset, _stream_shapes


class LinearMapper(BatchTransformer):
    """Apply a trained linear model: scores = (x − μ_A)·W + b, on the
    device the weights live on."""

    def __init__(
        self,
        weights: torch.Tensor,  # (d, k)
        intercept: Optional[torch.Tensor] = None,  # (k,)
        feature_mean: Optional[torch.Tensor] = None,  # (d,)
    ):
        self.weights = weights
        self.intercept = intercept
        self.feature_mean = feature_mean

    def apply_arrays(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.weights.device)
        if self.feature_mean is not None:
            x = x - self.feature_mean
        out = linalg.mm(x, self.weights)
        if self.intercept is not None:
            out = out + self.intercept
        return out


class LinearMapEstimator(GramStreamStateMixin, LabelEstimator):
    """OLS/ridge via the normal equations on ``device`` (default CUDA).

    ``reg=None`` → plain least squares; otherwise ridge with strength λ
    (reference: LinearMapper.scala:75-103).
    """

    #: Chunked-fit protocol (workflow/streaming.py): exact normal
    #: equations accumulate naturally over row chunks.
    supports_fit_stream = True

    #: 2-D partitioner protocol: the Gram carry blocks its feature rows
    #: (``gram_stream_step.model_block_step``) on a (data, model) mesh.
    supports_model_axis = True

    def __init__(self, reg: Optional[float] = None, device: DeviceLike = None):
        self.reg = reg
        self.device = device

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label)

    def fit_stream(self, stream, state=None) -> LinearMapper:
        """Row-chunked exact fit: the centering identity of the in-core
        solve (Σ(a−μ)(a−μ)ᵀ = AᵀA − n·μμᵀ) fed by per-chunk Gram
        accumulation — O(d²) residency, the feature matrix never exists.
        ``state`` seeds the carry (refit/state.py)."""

        def init(feat_spec, y_spec):
            d, k = _stream_shapes(feat_spec, y_spec)
            return self._seed_carry(state, d, k, stream.device)

        carry, info = stream.fold(init, linalg.gram_stream_step)
        n = info["num_examples"] + (state.num_examples if state else 0)
        self._capture_state(carry, n, reg=self.reg)
        return self._finish_from_stats(carry, n)

    def _finish_from_stats(self, carry, n: int) -> LinearMapper:
        """Exact solve from accumulated statistics alone — shared by the
        streamed fit and ``finish_from_state``."""
        gc, cc, mu_a, mu_b = linalg.gram_stream_finish(carry, n)
        w = linalg.solve_from_gram(gc, cc, reg=self.reg or 0.0)
        if not self.reg:  # singular-risk case only: fail loudly, not NaN
            linalg.check_finite(w, "LinearMapEstimator (reg=0, streaming)")
        return LinearMapper(w, intercept=mu_b, feature_mean=mu_a)

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        x = features.data.to(device=device, dtype=torch.float32)
        y = targets.data.to(device=device, dtype=torch.float32)
        # ``refine`` (the default mode): a fast Gram at the ``default``
        # product (bf16 on the card) plus two refinement steps against the
        # true residual at IEEE fp32, under the divergence guard. Every
        # other mode solves once from a Gram at its own product, read per
        # call (parallel/linalg.py).
        mode = linalg.solver_mode()
        if mode == "refine":
            gram_precision, refine_steps = "default", 2
        else:
            gram_precision, refine_steps = mode, 0
        # Over the fit's mesh (``partitioner.fit_mesh``): per-shard Gram,
        # column sums and residual partials, summed across the row shards.
        w, mu_a, mu_b = linalg.centered_solve_refined(
            x, y, features.num_examples, self.reg or 0.0,
            gram_precision=gram_precision, refine_steps=refine_steps, mesh=fit_mesh(self),
        )
        if not self.reg:  # singular-risk case only: fail loudly, not NaN
            linalg.check_finite(w, "LinearMapEstimator (reg=0)")
        return LinearMapper(w.to(device), intercept=mu_b.to(device), feature_mean=mu_a.to(device))


class LocalLeastSquaresEstimator(LabelEstimator):
    """Dense lstsq on the host for small problems; the model lands on
    ``device`` (default CUDA)
    (reference: nodes/learning/LocalLeastSquaresEstimator.scala:16-61)."""

    def __init__(self, reg: float = 0.0, device: DeviceLike = None):
        self.reg = reg
        self.device = device

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label)

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        x = features.data[: features.num_examples].cpu().numpy()
        y = targets.data[: targets.num_examples].cpu().numpy()
        mu_a, mu_b = x.mean(axis=0), y.mean(axis=0)
        xc, yc = x - mu_a, y - mu_b
        d = x.shape[1]
        if self.reg > 0:
            w = np.linalg.solve(xc.T @ xc + self.reg * np.eye(d), xc.T @ yc)
        else:
            w, *_ = np.linalg.lstsq(xc, yc, rcond=None)

        def put(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return LinearMapper(put(w), intercept=put(mu_b), feature_mean=put(mu_a))


class SparseLinearMapper(BatchTransformer):
    """Apply a dense model to host-sparse rows, on the device the weights
    live on (reference: nodes/learning/SparseLinearMapper.scala:13-50)."""

    def __init__(self, weights: torch.Tensor, intercept: Optional[torch.Tensor] = None):
        self.weights = weights
        self.intercept = intercept

    def apply_arrays(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.weights.device)
        out = linalg.mm(x, self.weights)
        if self.intercept is not None:
            out = out + self.intercept
        return out

    def apply(self, datum):
        if hasattr(datum, "toarray"):
            datum = np.asarray(datum.toarray(), dtype=np.float32).ravel()
        return super().apply(datum)

    def apply_batch(self, dataset: Dataset):
        from ..util.vectors import Densify

        if not isinstance(dataset, ArrayDataset):
            dataset = Densify(device=self.weights.device).apply_batch(dataset)
        return super().apply_batch(dataset)


__all__ = [
    "LinearMapEstimator",
    "LinearMapper",
    "LocalLeastSquaresEstimator",
    "SparseLinearMapper",
]
