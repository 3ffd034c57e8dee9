"""ZCA whitening.

Port of ``keystone_tpu/ops/learning/zca.py`` (reference:
nodes/learning/ZCAWhitener.scala:12-77). Fit: the column means, the SVD
of the centred rows (``torch.linalg.svd``; cuSOLVER on the card), and
W = V·diag((s²/(n−1)+ε)^-½)·Vᵀ, whose product goes through ``linalg.mm``
at the solver mode's precision. W does not depend on the SVD's signs.
Apply: (M − μ)·W.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
from ...workflow.pipeline import Estimator, Transformer


class ZCAWhitener(Transformer):
    """(M − μ)·W for a patch matrix M, on the device W lives on."""

    def __init__(self, whitener: torch.Tensor, means: torch.Tensor):
        self.whitener = whitener  # (d, d)
        self.means = means  # (d,)

    def apply(self, mat):
        x = torch.as_tensor(mat, dtype=torch.float32, device=self.whitener.device)
        return linalg.mm(x - self.means, self.whitener)

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, ArrayDataset):
            x = dataset.data.to(device=self.whitener.device, dtype=torch.float32)
            return ArrayDataset(linalg.mm(x - self.means, self.whitener), dataset.num_examples)
        return dataset.map(self.apply)


class ZCAWhitenerEstimator(Estimator):
    """Fit on the (first / full) patch matrix (reference: ZCAWhitener.scala
    fitSingle), on ``device`` (default CUDA)."""

    def __init__(self, eps: float = 0.1, device: DeviceLike = None):
        self.eps = eps
        self.device = device

    def fit(self, data: Dataset) -> ZCAWhitener:
        if isinstance(data, ArrayDataset):
            mat = data.data[: data.num_examples]
            if mat.ndim == 3:  # dataset of matrices: use the first, like the reference
                mat = mat[0]
        else:
            mat = np.asarray(data.take(1)[0])
        return self.fit_single(mat)

    def fit_single(self, mat) -> ZCAWhitener:
        device = resolve_device(self.device)
        if isinstance(mat, torch.Tensor):
            x = mat.to(device=device, dtype=torch.float32)
        else:
            x = torch.as_tensor(np.asarray(mat, dtype=np.float32), device=device)
        whitener, means = zca_fit(x, self.eps)
        return ZCAWhitener(whitener, means)


def zca_fit(mat: torch.Tensor, eps: float):
    """``(W, μ)`` of a float32 (n, d) matrix, as the JAX package's ``_zca_fit``."""
    means = mat.mean(dim=0)
    n = mat.shape[0]
    _, s, vt = torch.linalg.svd(mat - means, full_matrices=False)
    scale = (s**2 / (n - 1.0) + eps) ** -0.5
    return linalg.mm(vt.T * scale, vt), means
