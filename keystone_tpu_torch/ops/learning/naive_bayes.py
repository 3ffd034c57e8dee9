"""Multinomial naive Bayes.

Port of ``keystone_tpu/ops/learning/naive_bayes.py`` (reference:
nodes/learning/NaiveBayesModel.scala:21-69). The fit is closed form:
per-class feature sums (one-hot labelsᵀ · X, through the solver binding
as ``linalg.mm_t``'s row-chunked product) and class counts, followed by
the additively smoothed log estimates. The model maps features to
per-class log-posteriors  π + Θ·x.
"""

from __future__ import annotations

import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
from ...workflow.pipeline import BatchTransformer, LabelEstimator
from .block import _as_array_dataset


class NaiveBayesModel(BatchTransformer):
    def __init__(self, pi: torch.Tensor, theta: torch.Tensor):
        self.pi = pi        # (k,) log priors
        self.theta = theta  # (k, d) log conditionals

    def apply_arrays(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.theta.device)
        return self.pi + linalg.mm(x, self.theta.T)


class NaiveBayesEstimator(LabelEstimator):
    """lambda-smoothed multinomial NB (reference: NaiveBayesModel.scala:57-69),
    fitted on ``device`` (default CUDA)."""

    def __init__(self, num_classes: int, smoothing: float = 1.0, device: DeviceLike = None):
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.device = device

    def fit(self, data: Dataset, labels: Dataset) -> NaiveBayesModel:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        n = features.num_examples
        x = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data.reshape(-1)[:n].to(device=device, dtype=torch.long)
        pi, theta = nb_fit(x, y, self.num_classes, float(self.smoothing))
        return NaiveBayesModel(pi, theta)


def nb_fit(x: torch.Tensor, y: torch.Tensor, num_classes: int, lam: float):
    """(π, Θ) of ``x`` (n, d) under int labels ``y`` (n,), smoothing λ."""
    onehot = torch.nn.functional.one_hot(y, num_classes).to(x.dtype)
    class_counts = onehot.sum(dim=0)                              # (k,)
    feature_sums = linalg.mm_t(onehot, x)                          # (k, d)
    total = class_counts.sum()
    pi = torch.log(class_counts + lam) - torch.log(total + num_classes * lam)
    denom = feature_sums.sum(dim=1, keepdim=True) + lam * x.shape[1]
    theta = torch.log(feature_sums + lam) - torch.log(denom)
    return pi, theta


__all__ = ["NaiveBayesEstimator", "NaiveBayesModel", "nb_fit"]
