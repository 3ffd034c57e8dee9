"""Multi-class linear discriminant analysis.

Port of ``keystone_tpu/ops/learning/lda.py`` (reference:
nodes/learning/LinearDiscriminantAnalysis.scala:1-68, Rao's multiple
discriminant analysis via the eigendecomposition of S_W⁻¹·S_B). As in the
JAX package, the scatter matrices are formed on the host in float64 over
the one-hot class-assignment matrix and the eigenproblem is solved there
with numpy; the fitted projection is a ``LinearMapper`` on ``device``
(default CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...workflow.pipeline import LabelEstimator
from ..stats.core import _as_array_dataset
from .linear import LinearMapper


class LinearDiscriminantAnalysis(LabelEstimator):
    def __init__(self, num_dimensions: int, device: DeviceLike = None):
        self.num_dimensions = num_dimensions
        self.device = device

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        features = _as_array_dataset(data)
        targets = _as_array_dataset(labels)
        x = features.data[: features.num_examples].cpu().numpy().astype(np.float64)
        y = targets.data.cpu().numpy().astype(np.int64).ravel()[: x.shape[0]]

        classes = np.unique(y)
        onehot = (y[:, None] == classes[None, :]).astype(np.float64)  # (n, c)
        counts = onehot.sum(axis=0)                                   # (c,)
        class_means = (onehot.T @ x) / counts[:, None]                # (c, d)
        total_mean = x.mean(axis=0)

        # Within-class scatter: Σ_c Σ_{i∈c} (x−μ_c)(x−μ_c)ᵀ
        #                     = XᵀX − Σ_c n_c μ_c μ_cᵀ
        sw = x.T @ x - (class_means.T * counts) @ class_means
        # Between-class scatter: Σ_c n_c (μ_c−μ)(μ_c−μ)ᵀ
        diff = class_means - total_mean
        sb = (diff.T * counts) @ diff

        eigvals, eigvecs = np.linalg.eig(np.linalg.solve(sw, sb))
        order = np.argsort(-np.abs(eigvals))[: self.num_dimensions]
        w = np.real(eigvecs[:, order])
        return LinearMapper(torch.tensor(w, dtype=torch.float32, device=resolve_device(self.device)))
