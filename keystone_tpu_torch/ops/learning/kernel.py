"""Kernel methods: blockwise Gaussian kernel, Gauss-Seidel kernel ridge
regression, and kernel-block application, on one device.

Port of ``keystone_tpu/ops/learning/kernel.py`` (reference:
nodes/learning/KernelGenerator.scala:36-206,
nodes/learning/KernelMatrix.scala:17-90,
nodes/learning/KernelRidgeRegression.scala:37-275,
nodes/learning/KernelBlockLinearMapper.scala:28-90). The n×n kernel
matrix is never materialized:

- **Training** (Gauss-Seidel BCD on the dual, arXiv:1602.05310): per
  column block b, the (n_pad, bs) panel K(X, X_b), the block's residual
  K_bᵀW, and a bs×bs Cholesky solve of (K_bb + λI) on cuSOLVER. The JAX
  package's ``shard_map`` over the data axis and its psum-scatters
  collapse to one device.
- **Application** (``KernelBlockLinearMapper``): a loop over training-row
  blocks accumulating K(x, X_b)·W_b, so the (m, n) panel never exists at
  once — the JAX package's ring rotation on one device.

Behavioural parity: λ is applied as K_bb + λI (not λnI); the per-epoch
block order comes from ``np.random.default_rng(block_permuter)``; rows
are zero-padded to a multiple of the block (pad rows solve to exactly
zero duals). The JAX package also rounds rows to its device count, so
its pad rows can differ in number; the real rows' duals do not.

Reliability and observability: a halving ``DegradationLadder`` over the
block size, ``probe("KernelRidgeRegression.solve")`` at the head of each
attempt, ``fit_span`` / ``rung_span("kernel_ridge", …)`` and a
``solver:kernel_ridge:…`` profile-store observation per fit.
``KEYSTONE_KERNEL_NYSTROM=m`` (0 = off) fits the randomized Nyström
rung instead (``sketch/solvers.py::nystrom_krr``).

Products go through ``linalg.mm`` / ``linalg.mm_t`` at the solver mode's
precision, as the JAX package routes them through ``linalg.mm``. Every
entry point takes ``device=`` (default CUDA). The mesh, ``shard_map``
and 2-D parts are not ported.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...envknobs import env_int
from ...obs import names as _names
from ...obs import solver as solver_obs
from ...parallel import linalg
from ...reliability import DegradationLadder, halving_rungs, probe
from ...workflow.pipeline import BatchTransformer, Estimator, LabelEstimator
from .block import _as_array_dataset, _record_solver_observation


# ------------------------------------------------------------------- kernels


def gaussian_kernel_block(xa: torch.Tensor, xb: torch.Tensor, gamma: float) -> torch.Tensor:
    """exp(−γ‖a−b‖²) panel via one product and an elementwise epilogue."""
    an = torch.sum(xa * xa, dim=1, keepdim=True)
    bn = torch.sum(xb * xb, dim=1)
    sq = an - 2.0 * linalg.mm(xa, xb.T) + bn
    return torch.exp(-gamma * torch.clamp_min(sq, 0.0))


class KernelTransformer:
    """Materializes kernel blocks against fixed training data
    (reference: KernelGenerator.scala KernelTransformer + KernelMatrix)."""

    def __init__(self, train: torch.Tensor, gamma: float, num_train: int):
        self.train = train  # (n, d)
        self.gamma = gamma
        self.num_train = num_train

    def column_block(self, start: int, size: int) -> torch.Tensor:
        """K(X, X[start:start+size]) — (n, size)."""
        return gaussian_kernel_block(self.train, self.train[start : start + size], self.gamma)

    def diag_block(self, start: int, size: int) -> torch.Tensor:
        xb = self.train[start : start + size]
        return gaussian_kernel_block(xb, xb, self.gamma)


class BlockKernelMatrix:
    """Cache-managing view over kernel column blocks
    (reference: KernelMatrix.scala:50-90 BlockKernelMatrix): the cache is
    device residency of computed panels."""

    def __init__(self, transformer: KernelTransformer, cache_blocks: bool = True):
        self.transformer = transformer
        self.cache_blocks = cache_blocks
        self._cache = {}

    def __call__(self, start: int, size: int) -> torch.Tensor:
        key = (start, size)
        if self.cache_blocks and key in self._cache:
            return self._cache[key]
        block = self.transformer.column_block(start, size)
        if self.cache_blocks:
            self._cache[key] = block
        return block

    def diag_block(self, start: int, size: int) -> torch.Tensor:
        return self.transformer.diag_block(start, size)

    def unpersist(self) -> None:
        self._cache.clear()


class GaussianKernelGenerator(Estimator):
    """reference: KernelGenerator.scala GaussianKernelGenerator. Holds the
    training rows on ``device`` (default CUDA)."""

    def __init__(self, gamma: float, device: DeviceLike = None):
        self.gamma = gamma
        self.device = device

    def fit(self, data: Dataset) -> KernelTransformer:
        device = resolve_device(self.device)
        ds = _as_array_dataset(data, device)
        x = ds.data[: ds.num_examples].to(device=device, dtype=torch.float32)
        return KernelTransformer(x, self.gamma, ds.num_examples)


# ---------------------------------------------------------------------- KRR


class KernelRidgeRegression(LabelEstimator):
    """Gauss-Seidel block coordinate descent on the kernel dual, on the
    kernel generator's ``device``."""

    def __init__(
        self,
        kernel_generator: GaussianKernelGenerator,
        reg: float,
        block_size: int,
        num_epochs: int,
        block_permuter: Optional[int] = None,
    ):
        self.kernel_generator = kernel_generator
        self.reg = reg
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.block_permuter = block_permuter

    @property
    def device(self):
        return self.kernel_generator.device

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label)

    def fit(self, data: Dataset, labels: Dataset) -> "KernelBlockLinearMapper":
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        n = features.num_examples

        landmarks = env_int("KEYSTONE_KERNEL_NYSTROM", 0)
        if 0 < landmarks < n:
            return self._fit_nystrom(features, targets, landmarks, device)

        # OOM degradation: the live kernel panel is (n_pad, bs) — halving
        # the block halves it (and the bs×bs solve) while the Gauss-Seidel
        # sweep still visits every training row.
        bs0 = min(self.block_size, n)
        ladder = DegradationLadder(
            halving_rungs(bs0, max(bs0 // 4, 1)), label="KernelRidgeRegression.fit"
        )
        attempts = iter(range(len(ladder.rungs)))

        def attempt(bs):
            with solver_obs.rung_span("kernel_ridge", bs, next(attempts)):
                return self._fit_with_block(features, targets, bs, device)

        t_fit = time.perf_counter()
        with solver_obs.fit_span("kernel_ridge", n=n, epochs=self.num_epochs):
            model = ladder.run(attempt)
        if ladder.reduced:
            model.degradation = dict(ladder.record)
        _record_solver_observation(
            "kernel_ridge", rows=n, d=int(features.data.shape[1]), block_size=model.block_size,
            wall_s=time.perf_counter() - t_fit,
            rungs_attempted=1 + int(ladder.record.get("rung_index", 0)),
        )
        return model

    def _fit_nystrom(self, features, targets, landmarks, device) -> "KernelBlockLinearMapper":
        """Randomized Nyström rung (``KEYSTONE_KERNEL_NYSTROM=m``, 0=off):
        m uniform landmark rows stand in for the training set, the duals
        solve against the m×m landmark kernel (on the host, in float64),
        and scoring reuses the block mapper with the landmarks AS the
        training set — exactly K(x, landmarks)·α."""
        from ...sketch.solvers import nystrom_krr

        n = features.num_examples
        gamma = self.kernel_generator.gamma
        x = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data[: targets.num_examples].cpu().numpy().astype(np.float32)
        t_fit = time.perf_counter()
        with solver_obs.fit_span("kernel_nystrom", n=n, landmarks=landmarks):
            idx, duals = nystrom_krr(
                x, y, gamma, self.reg, landmarks, seed=env_int("KEYSTONE_SKETCH_SEED", 0)
            )
        _names.metric(_names.SKETCH_FITS).inc(variant="nystrom")
        _record_solver_observation(
            "kernel_nystrom", rows=n, d=int(x.shape[1]), block_size=landmarks,
            wall_s=time.perf_counter() - t_fit, rungs_attempted=1,
        )
        return KernelBlockLinearMapper(
            x[torch.from_numpy(idx).to(device)], duals, gamma,
            num_train=landmarks, block_size=min(self.block_size, landmarks),
        )

    def _fit_with_block(self, features, targets, bs: int, device) -> "KernelBlockLinearMapper":
        probe("KernelRidgeRegression.solve")
        n = features.num_examples
        gamma = self.kernel_generator.gamma
        n_pad = _round_up(n, bs)
        x = _pad_rows_to(features.data[:n].to(device=device, dtype=torch.float32), n_pad)
        y = _pad_rows_to(targets.data[:n].to(device=device, dtype=torch.float32), n_pad)

        num_blocks = n_pad // bs
        rng = np.random.default_rng(self.block_permuter)
        starts = []
        for _ in range(self.num_epochs):
            order = np.arange(num_blocks)
            if self.block_permuter is not None:
                rng.shuffle(order)
            starts.extend((order * bs).tolist())

        w = _krr_fit(x, y, starts, bs, gamma, float(self.reg), n)
        return KernelBlockLinearMapper(x, w, gamma, num_train=n, block_size=bs)


def _krr_fit(x, y, starts, bs: int, gamma: float, lam: float, n: int) -> torch.Tensor:
    """The Gauss-Seidel sweep over the column blocks at ``starts``: rows
    and columns at or past ``n`` (padding) are masked out of every panel,
    so their duals stay exactly zero."""
    n_pad = x.shape[0]
    w = torch.zeros(n_pad, y.shape[1], dtype=x.dtype, device=x.device)
    row_valid = (torch.arange(n_pad, device=x.device) < n).to(x.dtype)
    eye = torch.eye(bs, dtype=x.dtype, device=x.device)
    for s in starts:
        xb = x[s : s + bs]
        col_valid = row_valid[s : s + bs]
        k_panel = gaussian_kernel_block(x, xb, gamma) * row_valid[:, None] * col_valid[None, :]
        resid = linalg.mm_t(k_panel, w)  # (bs, k) = K_bᵀ·W
        kbb = gaussian_kernel_block(xb, xb, gamma) * col_valid[:, None] * col_valid[None, :]
        w_b_old = w[s : s + bs]
        rhs = y[s : s + bs] - (resid - linalg.mm(kbb.T, w_b_old))
        factor = torch.linalg.cholesky(kbb + lam * eye)
        w[s : s + bs] = torch.cholesky_solve(rhs, factor)
    return w


# ------------------------------------------------------------------- apply


class KernelBlockLinearMapper(BatchTransformer):
    """Apply the kernel model to test data: Σ_b K(x, X_b)·W_b over
    training-row blocks of ``block_size``, on the device the training
    rows live on (reference: KernelBlockLinearMapper.scala:28-90)."""

    # One panel per training block: keep it a standalone dispatch.
    fusable = False

    def __init__(self, train: torch.Tensor, duals: torch.Tensor, gamma: float,
                 num_train: int, block_size: int):
        self.train = train  # (n_pad, d)
        self.duals = duals  # (n_pad, k); zero rows at padding
        self.gamma = gamma
        self.num_train = num_train
        self.block_size = block_size

    def apply_arrays(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.train.device)
        acc = torch.zeros(x.shape[0], self.duals.shape[1], dtype=torch.float32, device=x.device)
        for start in range(0, self.train.shape[0], self.block_size):
            panel = gaussian_kernel_block(x, self.train[start : start + self.block_size], self.gamma)
            acc = acc + linalg.mm(panel, self.duals[start : start + self.block_size])
        return acc


# -------------------------------------------------------------------- utils


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows_to(a: torch.Tensor, target: int) -> torch.Tensor:
    if a.shape[0] == target:
        return a
    return torch.nn.functional.pad(a, (0, 0, 0, target - a.shape[0]))


__all__ = [
    "BlockKernelMatrix",
    "GaussianKernelGenerator",
    "KernelBlockLinearMapper",
    "KernelRidgeRegression",
    "KernelTransformer",
    "gaussian_kernel_block",
]
