"""k-means++ with Lloyd refinement.

Port of ``keystone_tpu/ops/learning/kmeans.py`` (reference:
nodes/learning/KMeansPlusPlus.scala:16-181): k-means++ seeding by D²
sampling, Lloyd iterations with relative-cost stopping (tolerance on the
mean min-distance), a model that emits the one-hot nearest-center
assignment matrix.

The seeding is the JAX package's host numpy, copied verbatim, so the
seeds are bit-equal to its (k sequential categorical draws over the
sample). Lloyd runs on the data's device as a Python loop with the JAX
``lax.while_loop``'s stop rule; its products go through ``linalg.mm``
at the solver mode's precision.

The estimator declares its fitted map's spec (``out_spec``) for the
plan-time verifier.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import Dataset
from ...obs import spans as _spans
from ...parallel import linalg
from ...workflow.pipeline import BatchTransformer, Estimator
from ..stats.core import _as_array_dataset


class KMeansModel(BatchTransformer):
    """x ↦ one-hot(nearest center): (n, d) → (n, k)."""

    def __init__(self, means: torch.Tensor):  # (k, d)
        self.means = means

    def apply_arrays(self, x):
        nearest = torch.argmin(_half_sq_dists(x, self.means), dim=1)
        return torch.nn.functional.one_hot(nearest, self.means.shape[0]).to(x.dtype)


def _half_sq_dists(x, means):
    """½‖x−m‖² up to a per-row constant — enough for argmin."""
    xn = 0.5 * torch.sum(x * x, dim=1, keepdim=True)
    mn = 0.5 * torch.sum(means * means, dim=1)
    return xn - linalg.mm(x, means.T) + mn


class KMeansPlusPlusEstimator(Estimator):
    def __init__(self, num_means: int, max_iterations: int,
                 stop_tolerance: float = 1e-3, seed: int = 0):
        self.num_means = num_means
        self.max_iterations = max_iterations
        self.stop_tolerance = stop_tolerance
        self.seed = seed

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label, out_width=self.num_means)

    def fit(self, data: Dataset) -> KMeansModel:
        ds = _as_array_dataset(data)
        x = ds.data[: ds.num_examples].to(torch.float32)
        with _spans.span("kmeans:seed", k=self.num_means, rows=int(x.shape[0])):
            init = _kmeanspp_init(x.cpu().numpy(), self.num_means, self.seed)
        with _spans.span("kmeans:lloyd") as sp:
            means, iterations = _lloyd(x, torch.from_numpy(init).to(x.device),
                                       self.max_iterations, self.stop_tolerance)
            sp.set_attribute("iterations", iterations)
        return KMeansModel(means)


def _kmeanspp_init(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """D²-weighted sequential seeding (reference: KMeansPlusPlus.scala:96-125)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    x_norm_half = 0.5 * np.einsum("ij,ij->i", x, x)
    centers = np.zeros(k, dtype=np.int64)
    centers[0] = rng.integers(n)
    cur_sq = None
    for j in range(k - 1):
        c = x[centers[j]]
        sq = x_norm_half - x @ c + 0.5 * float(c @ c)
        cur_sq = sq if cur_sq is None else np.minimum(cur_sq, sq)
        probs = np.maximum(cur_sq, 0.0)
        total = probs.sum()
        if total <= 0:
            centers[j + 1] = rng.integers(n)
        else:
            centers[j + 1] = rng.choice(n, p=probs / total)
    return x[centers]


def improved_by(gain, prev, tol) -> bool:
    """``gain >= tol·|prev|`` in float32 arithmetic, as the JAX loops test
    it; ``gain`` is the float32 difference of two float32 costs."""
    return bool(np.float32(gain) >= np.float32(tol) * np.abs(np.float32(prev)))


def _lloyd(x: torch.Tensor, means: torch.Tensor, max_iterations: int, tol: float):
    """Lloyd iterations: (means, iterations run). Each iteration assigns,
    recenters (a cluster that empties keeps its old center) and stops the
    loop once the mean min-distance improves by less than ``tol·|prev|``,
    as the JAX package's ``lax.while_loop`` does."""
    k = means.shape[0]
    prev_cost = np.float32(np.inf)
    i = 0
    improving = True
    while i < max_iterations and improving:
        dists = _half_sq_dists(x, means)
        cost = np.float32(torch.mean(torch.min(dists, dim=1).values).item())
        assign = torch.nn.functional.one_hot(torch.argmin(dists, dim=1), k).to(x.dtype)
        del dists
        mass = torch.sum(assign, dim=0)
        new_means = linalg.mm(assign.T, x) / torch.clamp_min(mass, 1.0)[:, None]
        means = torch.where(mass[:, None] > 0, new_means, means)
        improving = i == 0 or improved_by(prev_cost - cost, prev_cost, tol)
        prev_cost = cost
        i += 1
    return means, i
