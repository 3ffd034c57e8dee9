"""Kernel methods: blockwise Gaussian kernel, Gauss-Seidel kernel ridge
regression, and kernel-block application, on one device or over a mesh.

Port of ``keystone_tpu/ops/learning/kernel.py`` (reference:
nodes/learning/KernelGenerator.scala:36-206,
nodes/learning/KernelMatrix.scala:17-90,
nodes/learning/KernelRidgeRegression.scala:37-275,
nodes/learning/KernelBlockLinearMapper.scala:28-90). The n×n kernel
matrix is never materialized:

- **Training** (Gauss-Seidel BCD on the dual, arXiv:1602.05310): per
  column block b, the (n_pad, bs) panel K(X, X_b), the block's residual
  K_bᵀW, and a bs×bs Cholesky solve of (K_bb + λI) on cuSOLVER. Over a
  fit mesh with several row shards (``partitioner.fit_mesh``), as the
  JAX package's ``shard_map`` body: each shard holds its rows; block b's
  rows are a zero-padded (bs, d) block per shard reduced over the row
  axes (the psum of ``gather_block``), each shard computes its (rows, bs)
  panel and its part of K_bᵀW, and one ``allreduce_sum`` gives the
  residual. Sums run in shard order, so 8 shards against 1 differ only
  by the grouping of the residual's sum.
- **Application** (``KernelBlockLinearMapper``): a loop over training-row
  blocks accumulating K(x, X_b)·W_b, so the (m, n) panel never exists at
  once. Under an ambient mesh with several row shards it is the JAX
  package's ring: test rows stay on their shard while the training rows
  and duals travel the ``data`` ring (``ring_permute``), with one hop of
  the ``replica`` ring after each full data cycle on a hybrid mesh.

Behavioural parity: λ is applied as K_bb + λI (not λnI); the per-epoch
block order comes from ``np.random.default_rng(block_permuter)``; rows
are zero-padded to a multiple of the block (pad rows solve to exactly
zero duals) and, over a mesh, to a multiple of the row shards too, as
the JAX package rounds them to both.

Reliability and observability: a halving ``DegradationLadder`` over the
block size, ``probe("KernelRidgeRegression.solve")`` at the head of each
attempt, ``fit_span`` / ``rung_span("kernel_ridge", …)`` and a
``solver:kernel_ridge:…`` profile-store observation per fit.
``KEYSTONE_KERNEL_NYSTROM=m`` (0 = off) fits the randomized Nyström
rung instead (``sketch/solvers.py::nystrom_krr``).

Products go through ``linalg.mm`` / ``linalg.mm_t`` at the solver mode's
precision, as the JAX package routes them through ``linalg.mm``. Every
entry point takes ``device=`` (default CUDA).
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
from ...parallel.collectives import P, Sharded, allreduce_sum, axis_index, ring_permute
from ...parallel.mesh import (
    DATA_AXIS, REPLICA_AXIS, Mesh, get_mesh, require_one_process, row_axes, row_shard_count,
)
from ...parallel.partitioner import fit_mesh
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
        mesh = fit_mesh(self)
        n = features.num_examples
        gamma = self.kernel_generator.gamma
        ndev = row_shard_count(mesh)
        n_pad = _round_up_multiple(n, bs, ndev)
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

        w = _krr_fit(linalg._row_mesh(x, mesh), x, y, starts, bs, gamma, float(self.reg), n)
        return KernelBlockLinearMapper(x, w, gamma, num_train=n, block_size=bs)


def _krr_fit(mesh: Optional[Mesh], x, y, starts, bs: int, gamma: float, lam: float, n: int) -> torch.Tensor:
    """The Gauss-Seidel sweep over the column blocks at ``starts``, the
    JAX package's ``_krr_fit`` body per row shard of ``mesh`` (None: one
    shard, ``x``'s device). Rows and columns at or past ``n`` (padding)
    are masked out of every panel, so their duals stay exactly zero. The
    duals W are replicated: one copy per distinct device, updated with
    the same block solve."""
    axes = row_axes(mesh) if mesh is not None else ()
    xs = linalg._row_shards(x, mesh)
    ys = linalg._row_shards(y, mesh)
    pos = axis_index(mesh, axes) if mesh is not None else [0]
    devices = mesh.flat_devices if mesh is not None else (x.device,)
    n_local = xs[0].shape[0]
    n_pad, k = x.shape[0], y.shape[1]
    ws = {}
    for d in devices:
        if d not in ws:
            ws[d] = torch.zeros(n_pad, k, dtype=x.dtype, device=d)
    row_valid = [
        ((pos[i] * n_local + torch.arange(n_local, device=d)) < n).to(x.dtype) for i, d in enumerate(devices)
    ]

    def reduce_rows(parts):
        return allreduce_sum(parts, mesh, axes) if mesh is not None else parts

    def gather_block(shards, s):
        """Rows [s, s+bs) of the global matrix on every shard: each shard
        places its own rows in a zero (bs, ·) block, reduced over the
        row axes."""
        parts = []
        for i, local in enumerate(shards):
            out = torch.zeros(bs, local.shape[1], dtype=local.dtype, device=local.device)
            lo, hi = max(s, pos[i] * n_local), min(s + bs, (pos[i] + 1) * n_local)
            if lo < hi:
                out[lo - s : hi - s] = local[lo - pos[i] * n_local : hi - pos[i] * n_local]
            parts.append(out)
        return reduce_rows(parts)

    for s in starts:
        xbs = gather_block(xs, s)
        ybs = gather_block(ys, s)
        partials = []
        for i, d in enumerate(devices):
            col_valid = ((s + torch.arange(bs, device=d)) < n).to(x.dtype)
            k_panel = gaussian_kernel_block(xs[i], xbs[i], gamma) * row_valid[i][:, None] * col_valid[None, :]
            w_rows = ws[d][pos[i] * n_local : (pos[i] + 1) * n_local]
            partials.append(linalg.mm_t(k_panel, w_rows))  # this shard's part of K_bᵀ·W
        resids = reduce_rows(partials)
        # The block solve is the same on every shard: once per device.
        for d, w in ws.items():
            i = devices.index(d)
            col_valid = ((s + torch.arange(bs, device=d)) < n).to(x.dtype)
            kbb = gaussian_kernel_block(xbs[i], xbs[i], gamma) * col_valid[:, None] * col_valid[None, :]
            rhs = ybs[i] - (resids[i] - linalg.mm(kbb.T, w[s : s + bs]))
            factor = torch.linalg.cholesky(kbb + lam * torch.eye(bs, dtype=x.dtype, device=d))
            w[s : s + bs] = torch.cholesky_solve(rhs, factor)
    return ws[devices[0]]


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
        mesh = require_one_process(get_mesh(), "KernelBlockLinearMapper")
        if row_shard_count(mesh) > 1:
            return _ring_kernel_apply(mesh, x, self.train, self.duals, self.gamma)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.train.device)
        acc = torch.zeros(x.shape[0], self.duals.shape[1], dtype=torch.float32, device=x.device)
        for start in range(0, self.train.shape[0], self.block_size):
            panel = gaussian_kernel_block(x, self.train[start : start + self.block_size], self.gamma)
            acc = acc + linalg.mm(panel, self.duals[start : start + self.block_size])
        return acc


def _ring_kernel_apply(mesh: Mesh, x, train: torch.Tensor, duals: torch.Tensor, gamma: float) -> torch.Tensor:
    """K(x, train)·duals over ``mesh``'s row shards, as the JAX package's
    ``_ring_kernel_apply``: every shard keeps its test rows and
    accumulates one panel product per ring step while the training rows
    and duals rotate one hop of the ``data`` ring, and, after each full
    data cycle of a hybrid mesh, one hop of the ``replica`` ring, so the
    nd·nr steps visit every shard once."""
    axes = row_axes(mesh)
    nd = mesh.shape[DATA_AXIS]
    nr = mesh.shape.get(REPLICA_AXIS, 1)
    m = x.shape[0]
    x = torch.as_tensor(x, dtype=torch.float32, device=train.device)
    xt = linalg.prepare_row_sharded(_pad_rows_to(x, _round_up_multiple(m, row_shard_count(mesh))), mesh)
    xs = linalg.prepare_row_sharded(train, mesh).shards
    ws = linalg.prepare_row_sharded(duals, mesh).shards
    acc = [torch.zeros(t.shape[0], duals.shape[1], dtype=torch.float32, device=t.device) for t in xt.shards]
    for step in range(nd * nr):
        acc = [a + linalg.mm(gaussian_kernel_block(t, xi, gamma), wi) for a, t, xi, wi in zip(acc, xt.shards, xs, ws)]
        xs, ws = ring_permute(xs, mesh, DATA_AXIS), ring_permute(ws, mesh, DATA_AXIS)
        if nr > 1 and (step + 1) % nd == 0:
            xs, ws = ring_permute(xs, mesh, REPLICA_AXIS), ring_permute(ws, mesh, REPLICA_AXIS)
    out = Sharded(acc, P(axes), mesh, (xt.shape[0], duals.shape[1])).assemble()
    return out[:m]


# -------------------------------------------------------------------- utils


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _round_up_multiple(n: int, *multiples: int) -> int:
    """The least count ≥ ``n`` that every one of ``multiples`` divides."""
    out = n
    while any(out % m for m in multiples):
        for m in multiples:
            out = _round_up(out, m)
    return out


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
