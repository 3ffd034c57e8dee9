"""Diagonal-covariance Gaussian mixture model fit by EM.

Port of ``keystone_tpu/ops/learning/gmm.py`` (reference:
nodes/learning/GaussianMixtureModelEstimator.scala:25-203 and
nodes/learning/GaussianMixtureModel.scala:19-106), with the JAX package's
behaviour:

- init from one round of k-means++ (or uniform-random within the column
  range);
- global variance lower bound max(smallVarianceThreshold·var_global,
  absoluteVarianceThreshold), re-applied each M-step;
- posterior thresholding (weights < weightThreshold → 0, renormalized)
  in the training E-steps and in model application;
- stop when the mean log-likelihood stops improving by tolerance, or when
  any cluster would fall under min_cluster_size (the fit keeps the last
  good parameters, like the reference's largeEnoughClusters guard), or
  after max_iterations.

The EM loop is a Python loop on the data's device with the JAX
``lax.while_loop``'s stop rules; it reads one flag back per iteration.
E-step distances are two products (X·(μ/σ²)ᵀ and X²·(1/2σ²)ᵀ) through
``linalg.mm`` and the M-step two more, qᵀX and qᵀX², which contract the
sample axis, through ``linalg.mm_t`` (partial products of ``ROW_CHUNK``
rows summed), all at the solver mode's precision: the port's rule for
reductions over examples, which one cuBLAS contraction over VOC's 10⁶
samples broke (the variances E[x²] − μ² magnify a long sum's rounding).
The k-means++ seeding is host numpy, as in the JAX package; the initial
moments are taken on the device in float64, each sample given to its
nearest Lloyd centre as ``kmeans.py``'s Lloyd step does, for its reason.

The model stores means/variances as (d, k) — a column per cluster — as
the reference does (GaussianMixtureModel.scala:19-24); the Fisher-vector
encoder relies on it. A fitted model's ``fit_info`` records the k-means++
seed rows of its sample, the Lloyd iterations, the parameters EM started
from (``init_means``, ``init_variances``, ``init_weights``, (k, d) and
(k,)) and the EM iterations run and updates made;
``keystone_gmm_steps_total{step="em"}`` counts each EM iteration.

The estimator declares its fitted map's spec (``out_spec``) for the
plan-time verifier.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...obs import spans as _spans
from ...parallel import linalg
from ...workflow.pipeline import BatchTransformer, Estimator
from ..stats.core import _as_array_dataset
from .kmeans import KMeansModel, KMeansPlusPlusEstimator, _gmm_step, improved_by

KMEANS_PLUS_PLUS_INITIALIZATION = "kmeans++"
RANDOM_INITIALIZATION = "random"


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


class GaussianMixtureModel(BatchTransformer):
    """x ↦ thresholded posterior cluster assignments (n, k). Parameters
    given as arrays land on ``device`` (default CUDA); tensors stay where
    they are."""

    def __init__(self, means, variances, weights, weight_threshold: float = 1e-4,
                 device: DeviceLike = None, fit_info: Optional[dict] = None):
        def param(a):
            if isinstance(a, torch.Tensor):
                return a.to(torch.float32)
            return _f32(a, resolve_device(device))

        self.means = param(means)          # (d, k)
        self.variances = param(variances)  # (d, k)
        self.weights = param(weights).reshape(-1)  # (k,)
        self.weight_threshold = weight_threshold
        #: How a fit made it (``GaussianMixtureModelEstimator.fit``); None
        #: for given parameters.
        self.fit_info = fit_info
        if self.means.shape != self.variances.shape or self.weights.shape[0] != self.means.shape[1]:
            raise ValueError(
                f"GMM parameter shapes disagree: means {tuple(self.means.shape)}, variances "
                f"{tuple(self.variances.shape)}, weights {tuple(self.weights.shape)}"
            )

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def apply_arrays(self, x):
        return _gmm_posteriors(x, self.means.T, self.variances.T, self.weights, self.weight_threshold)

    @staticmethod
    def load(mean_file: str, vars_file: str, weights_file: str,
             device: DeviceLike = None) -> "GaussianMixtureModel":
        """CSV warm-start (reference: GaussianMixtureModel.scala:97-105)."""
        means = np.loadtxt(mean_file, delimiter=",", ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=",", ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=",").ravel()
        return GaussianMixtureModel(means, variances, weights, device=device)


def _gmm_log_likelihood(x, means, variances, weights):
    """Per-sample per-cluster log-likelihood. means/vars here are (k, d)."""
    d = x.shape[1]
    xsq = x * x
    inv_var = 1.0 / variances
    sq_mahal = (
        linalg.mm(xsq, (0.5 * inv_var).T)
        - linalg.mm(x, (means * inv_var).T)
        + 0.5 * torch.sum(means * means * inv_var, dim=1)
    )
    log_two_pi = torch.log(torch.tensor(2 * math.pi, dtype=torch.float32, device=x.device))
    log_norm = (
        -0.5 * d * log_two_pi
        - 0.5 * torch.sum(torch.log(variances), dim=1)
        + torch.log(weights)
    )
    return log_norm - sq_mahal


def _threshold_posteriors(llh, weight_threshold):
    """Softmax over clusters, entries ≤ the threshold zeroed, rows
    renormalized."""
    q = torch.exp(llh - torch.max(llh, dim=1, keepdim=True).values)
    q = q / torch.sum(q, dim=1, keepdim=True)
    q = torch.where(q > weight_threshold, q, torch.zeros((), dtype=q.dtype, device=q.device))
    return q / torch.clamp_min(torch.sum(q, dim=1, keepdim=True), 1e-30)


def _gmm_posteriors(x, means, variances, weights, weight_threshold):
    return _threshold_posteriors(_gmm_log_likelihood(x, means, variances, weights), weight_threshold)


class GaussianMixtureModelEstimator(Estimator):
    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        min_cluster_size: int = 40,
        stop_tolerance: float = 1e-4,
        weight_threshold: float = 1e-4,
        small_variance_threshold: float = 1e-2,
        absolute_variance_threshold: float = 1e-9,
        initialization_method: str = KMEANS_PLUS_PLUS_INITIALIZATION,
        seed: int = 0,
    ):
        if min_cluster_size <= 0 or max_iterations <= 0:
            raise ValueError("min_cluster_size and max_iterations must be positive")
        self.k = k
        self.max_iterations = max_iterations
        self.min_cluster_size = min_cluster_size
        self.stop_tolerance = stop_tolerance
        self.weight_threshold = weight_threshold
        self.small_variance_threshold = small_variance_threshold
        self.absolute_variance_threshold = absolute_variance_threshold
        self.initialization_method = initialization_method
        self.seed = seed

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label, out_width=self.k)

    def fit(self, data: Dataset) -> GaussianMixtureModel:
        ds = _as_array_dataset(data)
        x = ds.data[: ds.num_examples].to(torch.float32)
        device = x.device
        host = x.cpu().numpy()
        n, d = host.shape

        info = {"seed_rows": None, "lloyd_iterations": 0}
        if self.initialization_method == KMEANS_PLUS_PLUS_INITIALIZATION:
            km = KMeansPlusPlusEstimator(self.k, 1, seed=self.seed).fit(ArrayDataset(x))
            info.update(km.fit_info)
            x64 = x.to(torch.float64)
            assign = KMeansModel(km.means.to(torch.float64)).apply_arrays(x64)
            mass = assign.sum(dim=0)
            safe = torch.clamp_min(mass, 1.0)[:, None]
            means0 = linalg.mm_t(assign, x64) / safe
            vars0 = linalg.mm_t(assign, x64 * x64) / safe - means0**2
            means0, vars0, weights0 = (t.to(torch.float32) for t in (means0, vars0, mass / n))
            del assign, x64
        else:
            rng = np.random.default_rng(self.seed)
            lo, hi = host.min(axis=0), host.max(axis=0)
            span = hi - lo
            means0 = _f32(rng.uniform(size=(self.k, d)).astype(np.float32) * span + lo, device)
            vars0 = _f32(np.tile(0.1 * span * span, (self.k, 1)), device)
            weights0 = _f32(np.full(self.k, 1.0 / self.k), device)

        var_global = host.var(axis=0)
        var_lb = _f32(np.maximum(
            self.small_variance_threshold * var_global, self.absolute_variance_threshold
        ), device)
        vars0 = torch.maximum(vars0, var_lb)
        info.update(init_means=means0.cpu().numpy(), init_variances=vars0.cpu().numpy(),
                    init_weights=weights0.cpu().numpy())

        with _spans.span("gmm:em", k=self.k, rows=n) as sp:
            means, variances, weights, iterations, updates = _gmm_em(
                x, means0, vars0, weights0, var_lb, self.max_iterations,
                self.stop_tolerance, self.weight_threshold, self.min_cluster_size,
            )
            sp.set_attribute("iterations", iterations)
            sp.set_attribute("updates", updates)
        info.update(em_iterations=iterations, em_updates=updates)
        return GaussianMixtureModel(means.T, variances.T, weights, self.weight_threshold, fit_info=info)


def _gmm_em(x, means, variances, weights, var_lb, max_iterations, tol,
            weight_threshold, min_cluster_size):
    """EM from the given parameters: (means, variances, weights,
    iterations run, updates made). An iteration updates the parameters
    only while the mean log-likelihood improves by ``tol·|prev|`` (always
    on the first) and every cluster's posterior mass is at least
    ``min_cluster_size``; the first iteration that does not update ends
    the loop, as the JAX package's ``lax.while_loop`` does."""
    n = x.shape[0]
    xsq = x * x
    prev_cost = np.float32(-np.inf)
    i = updates = 0
    keep_going = True
    while i < max_iterations and keep_going:
        llh = _gmm_log_likelihood(x, means, variances, weights)
        cost = np.float32(torch.mean(torch.logsumexp(llh, dim=1)).item())
        improving = i == 0 or improved_by(cost - prev_cost, prev_cost, tol)
        q = _threshold_posteriors(llh, weight_threshold)
        del llh
        q_sum = torch.sum(q, dim=0)
        keep_going = improving and bool(torch.all(q_sum >= min_cluster_size))
        if keep_going:
            safe = torch.clamp_min(q_sum, 1e-12)[:, None]
            means = linalg.mm_t(q, x) / safe
            variances = torch.maximum(linalg.mm_t(q, xsq) / safe - means**2, var_lb)
            weights = q_sum / n
            updates += 1
        del q
        prev_cost = cost
        i += 1
        _gmm_step("em")
    return means, variances, weights, i, updates
