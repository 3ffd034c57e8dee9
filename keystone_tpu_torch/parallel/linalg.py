"""Dense linear algebra for the least-squares solvers, on one device.

Port of the single-device part of ``keystone_tpu/parallel/linalg.py``:
the solver products ``mm`` / ``mm_t`` / ``addmm_t_`` (and ``_mm_nt``, a·bᵀ
in column chunks, for the sketched solvers), ``gram``,
``normal_equations_solve``, ``tsqr_r`` / ``tsqr_svd``, the streaming Gram
statistics (``gram_stream_init`` / ``gram_stream_step`` /
``gram_stream_block_step`` / ``gram_stream_finish``), ``solve_spd``,
``solve_from_gram``, ``centered_solve_refined`` with its divergence
guard, ``check_finite``, ``bcd_from_gram``, ``block_coordinate_descent``
and its rematerialized and host-streamed variants, and the solver
precision modes (``solver_mode`` / ``solver_mode_scope`` /
``precision_for_mode``). The JAX package's ``lax.scan`` over blocks is a
Python loop here, and unlike it every block coordinate descent of more
than one pass forms each block's Gram and Cholesky factor once, keeping
the factor for the later passes while the factors fit in the device's
free memory (``_BlockFactors``), as the published KeystoneML solver does.

Over a mesh (``parallel/mesh.py``): ``prepare_row_sharded``, ``gram``,
``normal_equations_solve``, ``centered_solve_refined``, ``tsqr_r`` /
``tsqr_svd`` and the three block coordinate descents take ``mesh=``; with
more than one row shard they loop over the shards around the collectives
of ``parallel/collectives.py`` (per-shard partial products, one
``allreduce_sum`` per reduction, the small solves once on the first
shard's device), as the JAX package's ``shard_map`` bodies do with
``psum``. ``prepare_block_sharded``, ``block_coordinate_descent_2d`` and
``block_sharded_apply`` are the 2-D (``data`` × ``model``) layouts. Rows
are zero-padded to a shard multiple, and a pad row adds nothing to a
Gram; the centered solves take the logical row count ``n``. ``mesh=None``
is one device: unlike the JAX package the port reads no ambient mesh
here; the estimators (``block``, ``linear``, ``lbfgs``, ``logistic``,
``pca``, ``kernel``, ``conv_block``) pass ``partitioner.fit_mesh(self)``.
``gmm`` has no mesh path in either package: its products are plain
``mm``. On a mesh that spans processes each process passes its own rows
and the reductions cross processes (``parallel/collectives.py``);
``gram`` is the path the two-process rehearsal runs
(``parallel/rehearsal.py``). The estimators refuse such a mesh
(``mesh.require_one_process``). A block-sparse ``gram``
ignores the mesh, as in the JAX package.

Precision is pinned per call, never through a process-wide flag. Each
product reads ``solver_mode()`` when it runs and, on a CUDA tensor, goes
through the cuBLAS binding (``ops/cuda/gemm.py``) at that mode's product
kind:

==========  =====================================  ===========================
mode        JAX (TPU)                              port, CUDA tensor
==========  =====================================  ===========================
highest     ``Precision.HIGHEST`` (6-pass bf16)    ``ieee_fp32``
high        ``Precision.HIGH``                     ``tf32``
default     ``Precision.DEFAULT`` (1-pass bf16)    ``bf16`` (fp32 accumulation)
refine      Gram at DEFAULT + 2 IR steps + guard;  exact solver's Gram ``bf16``;
            every other product HIGHEST            every other product ``ieee_fp32``
==========  =====================================  ===========================

float64 tensors run IEEE fp64 whatever the mode; CPU tensors run
``torch.matmul`` in their own type, as the JAX package's CPU backend
ignores matmul precision. The Cholesky factorisations and triangular
solves are ``torch.linalg.cholesky`` / ``torch.cholesky_solve``
(cuSOLVER).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..envknobs import env_raw
from ..obs import cost as _cost
from ..obs import names as _names
from ..obs import spans as _spans
from ..ops.cuda import gemm as _gemm
from ..reliability.errors import is_oom
from .collectives import P, Sharded, _fan_out, _to, all_gather, all_to_all, allreduce_sum, axis_index, shard_tensor
from .mesh import MODEL_AXIS, Mesh, get_mesh, model_axis_size, row_axes, row_shard_count

# ------------------------------------------------------------ precision modes

#: ``KEYSTONE_SOLVER_PRECISION`` mode → the product kind it runs at on the
#: card (module docstring). ``refine`` also selects the exact solver's
#: fast Gram and iterative refinement (``LinearMapEstimator.fit``).
_PRECISION_MODES = {
    "highest": "ieee_fp32",
    "high": "tf32",
    "default": "bf16",
    "refine": "ieee_fp32",
}

# Measured-knob override: replaces the DEFAULT mode only — an explicit
# KEYSTONE_SOLVER_PRECISION always wins. Thread-local, so a scoped
# override never leaks into a concurrent fit on another thread.
_mode_override_local = threading.local()


def set_solver_mode_override(mode: "str | None") -> None:
    """Install (or clear, with None) the default-precision mode for the
    CURRENT THREAD. Raises on unknown modes. Prefer
    :func:`solver_mode_scope`: an unscoped install leaks into every later
    solve on the thread."""
    if mode is not None and mode not in _PRECISION_MODES:
        raise ValueError(
            f"solver mode override {mode!r}: expected one of {sorted(_PRECISION_MODES)}"
        )
    _mode_override_local.mode = mode


@contextlib.contextmanager
def solver_mode_scope(mode: "str | None"):
    """Scoped default-precision override: installed on entry, restored on
    exit, thread-local throughout. ``None`` is a no-op scope. This is how
    an estimator's ``solver_precision`` pin applies around its fit only."""
    if mode is None:
        yield
        return
    prev = getattr(_mode_override_local, "mode", None)
    set_solver_mode_override(mode)
    try:
        yield
    finally:
        _mode_override_local.mode = prev


def solver_mode() -> str:
    """The ``KEYSTONE_SOLVER_PRECISION`` mode, read per call. Resolution
    order: explicit env var > this thread's override > ``"refine"``."""
    env = env_raw("KEYSTONE_SOLVER_PRECISION")
    override = getattr(_mode_override_local, "mode", None)
    if env is not None:
        name = env.lower()
    elif override is not None:
        name = override
    else:
        name = "refine"
    if name not in _PRECISION_MODES:
        raise ValueError(
            f"KEYSTONE_SOLVER_PRECISION={name!r}: expected one of {sorted(_PRECISION_MODES)}"
        )
    return name


def precision_for_mode(mode: str) -> str:
    """The product kind (``"ieee_fp32"``, ``"tf32"`` or ``"bf16"``) of a
    ``KEYSTONE_SOLVER_PRECISION`` mode name."""
    if mode not in _PRECISION_MODES:
        raise ValueError(f"precision mode {mode!r}: expected one of {sorted(_PRECISION_MODES)}")
    return _PRECISION_MODES[mode]


def precision() -> str:
    """The current solver-grade product kind (per-call read)."""
    return precision_for_mode(solver_mode())


# ------------------------------------------------------------------ products

#: Rows per partial product in :func:`mm_t` and :func:`addmm_t_`.
ROW_CHUNK = _gemm.ROW_CHUNK


def _note_host_product(kind: str, m: int, n: int, k: int, itemsize: int) -> None:
    """The host products below stand in for the binding's: they note the
    same facts to the cost observatory as ``ops/cuda/gemm.py`` does."""
    _cost.note_launch("gemm", kind, m=m, n=n, k=k, itemsize=itemsize)


def _mm(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        _note_host_product(kind, a.shape[0], b.shape[-1], a.shape[-1], a.element_size())
        return torch.matmul(a, b)
    return _gemm.gemm(a, b, kind)


def _addmm_t_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (out, a, b)):
        _note_host_product(kind, a.shape[1], b.shape[1], a.shape[0], a.element_size())
        for start in range(0, a.shape[0], ROW_CHUNK):
            out.addmm_(a[start : start + ROW_CHUNK].T, b[start : start + ROW_CHUNK])
        return out
    return _gemm.gemm_tn_chunked(a, b, kind, out=out, beta=1.0)


def _mm_t(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        out = torch.zeros(a.shape[1], b.shape[1], dtype=a.dtype)
        return _addmm_t_(out, a, b, kind)
    return _gemm.gemm_tn_chunked(a, b, kind)


def _mm_nt(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """a·bᵀ contracting the COLUMN axis in ``ROW_CHUNK``-column partial
    products summed into the output — :func:`mm_t`'s reason, for a long
    feature axis: the sketched solvers' K = SAc·SAcᵀ over 204,800 columns
    (chip_smoke.py ``timit_sketched`` reads both forms against float64)."""
    out = torch.zeros(a.shape[0], b.shape[0], dtype=a.dtype, device=a.device)
    on_cpu = a.device.type == "cpu" and b.device.type == "cpu"
    if on_cpu:
        _note_host_product(kind, a.shape[0], b.shape[0], a.shape[1], a.element_size())
    for start in range(0, a.shape[1], ROW_CHUNK):
        ab, bb = a[:, start : start + ROW_CHUNK], b[:, start : start + ROW_CHUNK]
        if on_cpu:
            out.addmm_(ab, bb.T)
        else:
            _gemm.gemm(ab, bb.T, kind, out=out, beta=1.0)
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solver-grade matrix product at the current mode's precision."""
    return _mm(a, b, precision())


def mm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ·b at the current mode's precision, contracting the example axis
    in chunks of ``ROW_CHUNK`` rows whose products are summed. cuBLAS
    accumulates one long fp32 run over the contraction; over 65,536
    centered rows that put the in-core fit's scores 1.7e-4 (relative)
    from a float64 fit on an H100 (chip_smoke.py), where the block-sparse
    path's were 6.3e-7."""
    return _mm_t(a, b, precision())


def addmm_t_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out += aᵀ·b`` in place, one ``ROW_CHUNK``-row partial product at
    a time (the contraction :func:`mm_t` makes, accumulated into an
    existing sum), at the current mode's precision."""
    return _addmm_t_(out, a, b, precision())


# ------------------------------------------------------------ row sharding


def _pad_rows(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """``a`` with zero rows appended up to a multiple of ``multiple`` (one
    copy when padding is needed, ``a`` itself otherwise)."""
    rows = a.shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return a
    return torch.cat([a, a.new_zeros((target - rows,) + tuple(a.shape[1:]))])


def prepare_row_sharded(a, mesh: Optional[Mesh] = None) -> Sharded:
    """``a`` zero-padded to a multiple of the mesh's row shards and laid
    out by rows over them (``P(row_axes)``; replicated over ``model``).
    On ``a``'s own device each shard is a view of its rows. Default mesh:
    the ambient one."""
    if isinstance(a, Sharded):
        return a
    mesh = mesh or get_mesh()
    a = torch.as_tensor(a)
    return shard_tensor(_pad_rows(a, row_shard_count(mesh)), mesh, P(row_axes(mesh)))


def _row_mesh(a, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a solver shards ``a``'s rows over, or None for the
    single-device path: one row shard, no mesh, or a ``meta`` tensor
    (the verifier's shape trace)."""
    if isinstance(a, Sharded):
        return a.mesh
    if mesh is None or row_shard_count(mesh) <= 1 or a.device.type == "meta":
        return None
    return mesh


def _row_shards(a, mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Per-shard rows of ``a`` (``[a]`` without a mesh)."""
    if mesh is None:
        return [a]
    return prepare_row_sharded(a, mesh).shards


def _reduce(parts: List[torch.Tensor], mesh: Optional[Mesh], axes=None) -> torch.Tensor:
    """Σ of per-shard partials over ``axes`` (default: the row axes),
    summed in shard order (``allreduce_sum``); the first shard's copy.
    Without a mesh, the one partial."""
    if mesh is None:
        return parts[0]
    return allreduce_sum(parts, mesh, axes or row_axes(mesh))[0]


def _bcast(t: torch.Tensor, mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """``t`` on every shard's device (one copy per distinct device)."""
    if mesh is None:
        return [t]
    return _fan_out(t, mesh.flat_devices)


# ------------------------------------------------------------- gram / solve


def gram(
    a,
    b: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(AᵀA, AᵀB) — AᵀB is None without ``b``. Zero-padded rows
    contribute nothing. Over a ``mesh`` with several row shards: each
    shard's partial product, summed by ``allreduce_sum``.

    ``a`` may be a host-side
    :class:`~keystone_tpu_torch.utils.sparse.BlockSparseMatrix`: the Gram
    then comes from ``bsr_gram_totals`` (the ELL kernel on a card), on
    ``b``'s device, or on ``device`` without ``b`` — single-device, the
    mesh ignored (as in the JAX package)."""
    from ..utils.sparse import BlockSparseMatrix

    if isinstance(a, BlockSparseMatrix):
        from ..ops.cuda.blocksparse import bsr_gram_totals

        y = b if b is not None else torch.zeros(a.shape[0], 1, device=resolve_device(device))
        g, c, _sa, _sb = bsr_gram_totals(a, y)
        return g, (None if b is None else c)
    mesh = _row_mesh(a, mesh)
    xs = _row_shards(a, mesh)
    g = _reduce([mm_t(x, x) for x in xs], mesh)
    if b is None:
        return g, None
    ys = _row_shards(b, mesh)
    return g, _reduce([mm_t(x, y) for x, y in zip(xs, ys)], mesh)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; raises on a matrix that is not positive
    definite (the JAX reference would return NaNs silently)."""
    return torch.linalg.cholesky(a)


def solve_spd(ata: torch.Tensor, atb: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (AᵀA + reg·I) x = Aᵀb by Cholesky."""
    d = ata.shape[0]
    lhs = ata + reg * torch.eye(d, dtype=ata.dtype, device=ata.device)
    return torch.cholesky_solve(atb, _cholesky(lhs))


def normal_equations_solve(
    a: torch.Tensor, b: torch.Tensor, reg: float = 0.0, mesh: Optional[Mesh] = None
) -> torch.Tensor:
    """One-shot least squares: x = (AᵀA + λI)⁻¹ Aᵀb (Gram over ``mesh``,
    the solve once)."""
    ata, atb = gram(a, b, mesh=mesh)
    return solve_spd(ata, atb, reg=reg)


def tsqr_r(a: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """R factor of a tall-skinny matrix (mlmatrix ``TSQR``): a local QR
    per row shard, the small R factors gathered (``all_gather``), and one
    QR of their stack. On one device, one QR of ``a``."""
    mesh = _row_mesh(a, mesh)
    if mesh is None:
        return torch.linalg.qr(a, mode="r")[1]
    rs = [torch.linalg.qr(x, mode="r")[1] for x in _row_shards(a, mesh)]
    stacked = all_gather(rs, mesh, row_axes(mesh))[0]
    return torch.linalg.qr(stacked.reshape(-1, stacked.shape[-1]), mode="r")[1]


def tsqr_svd(a: torch.Tensor, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Singular values and right singular vectors (Vᵀ) of ``a`` via the
    SVD of its TSQR R factor: A = QR, R = UΣVᵀ ⇒ A's (Σ, V) are R's."""
    _, s, vt = torch.linalg.svd(tsqr_r(a, mesh=mesh), full_matrices=False)
    return s, vt


# ---------------------------------------------------------- Gram statistics


def gram_stream_init(d: int, k: int, device: torch.device, dtype=torch.float32):
    """Zero sufficient statistics (G=AᵀA, C=AᵀY, Σx, Σy)."""
    return (
        torch.zeros(d, d, dtype=dtype, device=device),
        torch.zeros(d, k, dtype=dtype, device=device),
        torch.zeros(d, dtype=dtype, device=device),
        torch.zeros(k, dtype=dtype, device=device),
    )


def gram_stream_step(carry, x: torch.Tensor, y: torch.Tensor):
    """Add one chunk's contribution to the sufficient statistics IN PLACE
    and return the carry — the port's counterpart of the JAX package's
    donated carry: no second (d, d) buffer per chunk. The chunk's rows
    are contracted in ``ROW_CHUNK``-row partial products
    (:func:`addmm_t_`), for :func:`mm_t`'s reason, at the current mode's
    precision. Pad rows must be exactly zero (the streaming engine
    re-zeroes them)."""
    g, c, sa, sb = carry
    x = x.to(g.dtype)
    y = y.to(g.dtype)
    addmm_t_(g, x, x)
    addmm_t_(c, x, y)
    sa.add_(x.sum(dim=0))
    sb.add_(y.sum(dim=0))
    return carry


def gram_stream_block_step(carry, x: torch.Tensor, y: torch.Tensor, block_index: int):
    """Feature-block variant of :func:`gram_stream_step`: the carry holds
    only the ``block_index``-th row block of G (and of C, Σx) — (b, d)
    instead of (d, d) — and takes its own column slice of the full chunk
    ``x``; Σy is feature-free, so only block 0 accumulates it. Summed
    over every block index, the blocks are :func:`gram_stream_step`'s
    carry. Updates in place and returns the carry."""
    g, c, sa, sb = carry
    b = g.shape[0]
    x = x.to(g.dtype)
    y = y.to(g.dtype)
    xb = x[:, block_index * b : (block_index + 1) * b]
    addmm_t_(g, xb, x)
    addmm_t_(c, xb, y)
    sa.add_(xb.sum(dim=0))
    if block_index == 0:
        sb.add_(y.sum(dim=0))
    return carry


# Blocked-carry protocol (the JAX package's 2-D streaming layouts): which
# axis of each carry leaf is the feature axis (None = feature-free).
gram_stream_step.model_layout = (0, 0, 0, None)
gram_stream_step.model_block_step = gram_stream_block_step


def gram_stream_finish(carry, n: int):
    """Centered Gram/cross products + column means from the accumulated
    statistics: ``(Gc, Cc, mu_a, mu_b)``, by the algebraic identity
    Σ(x−μ)(x−μ)ᵀ = G − n·μμᵀ (no centered copy exists)."""
    g, c, sa, sb = carry
    mu_a = sa / n
    mu_b = sb / n
    gc = g - n * torch.outer(mu_a, mu_a)
    cc = c - n * torch.outer(mu_a, mu_b)
    return gc, cc, mu_a, mu_b


def solve_from_gram(gc: torch.Tensor, cc: torch.Tensor, reg: float) -> torch.Tensor:
    """Exact ridge solve from centered sufficient statistics — the
    streaming analog of the normal-equation solve."""
    return solve_spd(gc, cc, reg=reg)


# Test seam for the refine-mode divergence guard: host-CPU products have
# one precision, so tests set this to corrupt the fast Gram
# deterministically and check the guard recovers the IEEE-Gram solution.
# Never set in production.
_TEST_GRAM_PERTURB: float = 0.0


def _centered_factor(xs, ys, n, reg, kind, mesh, perturb=0.0):
    """Gram at ``kind`` (plus the test seam's ``perturb``) → centering →
    Cholesky: ``(w, factor, atb_c, μ_a, μ_b)``. ``xs`` / ``ys`` are the
    row shards (one each without a mesh)."""
    d = xs[0].shape[1]
    mu_a = _reduce([x.sum(dim=0) for x in xs], mesh) / n
    mu_b = _reduce([y.sum(dim=0) for y in ys], mesh) / n
    ata = _reduce([_mm_t(x, x, kind) for x in xs], mesh)
    atb = _reduce([_mm_t(x, y, kind) for x, y in zip(xs, ys)], mesh)
    if perturb:
        ata = ata + perturb * (torch.trace(ata) / d) * torch.ones_like(ata)
    ata_c = ata - n * torch.outer(mu_a, mu_a)
    atb_c = atb - n * torch.outer(mu_a, mu_b)
    factor = _cholesky(ata_c + reg * torch.eye(d, dtype=ata.dtype, device=ata.device))
    return torch.cholesky_solve(atb_c, factor), factor, atb_c, mu_a, mu_b


def centered_solve_refined(
    x: torch.Tensor,
    y: torch.Tensor,
    n: int,
    reg: float,
    gram_precision: Optional[str] = None,
    refine_steps: int = 0,
    resid_precision: str = "highest",
    mesh: Optional[Mesh] = None,
):
    """Centered ridge solve ``(w, μ_a, μ_b)`` with optional mixed-precision
    iterative refinement, as the JAX package's fused solve.

    The Gram and cross products of ``x`` / ``y`` (zero pad rows allowed;
    ``n`` is the real row count) are taken at ``gram_precision`` (a mode
    name; None: the current mode), centered
    algebraically (Σ(a−μ)(a−μ)ᵀ = AᵀA − n·μμᵀ) and factored. Each of the
    ``refine_steps`` steps recomputes the TRUE residual of the centered
    system from ``x`` at ``resid_precision``, with S = Y − X·W,

        A_cᵀ(B_c − A_c·W) − λW = XᵀS − μ_a·(1ᵀS) − λW,

    and corrects W through the same factor. Over a ``mesh`` with several
    row shards, every product and column sum is a per-shard partial
    summed by ``allreduce_sum``; the factor and the corrections run once.

    Divergence guard (when ``refine_steps > 0`` and the Gram is not IEEE
    fp32): refinement contracts the error by about cond(Gram)·ε_gram per
    step, so on a badly conditioned system it can stall or diverge. The
    final iterate's residual norm is measured, and when it is not at most
    half the initial one — and the initial one is above the roundoff
    floor 1e-5·(‖A_cᵀB_c‖ + λ‖W‖) — the solve is redone from an IEEE fp32
    Gram with the same steps. The decision reads two norms back to the
    host once; ``centered_solve_refined.guard_checks`` and
    ``.guard_fired`` count the decisions and the fallbacks."""
    mesh = _row_mesh(x, mesh)
    xs = [t.to(torch.float32) for t in _row_shards(x, mesh)]
    ys = [t.to(torch.float32) for t in _row_shards(y, mesh)]
    kind = precision_for_mode(gram_precision or solver_mode())
    resid_kind = precision_for_mode(resid_precision)
    w, factor, atb_c, mu_a, mu_b = _centered_factor(xs, ys, n, reg, kind, mesh, _TEST_GRAM_PERTURB)
    if refine_steps == 0:
        return w, mu_a, mu_b

    def resid(w):
        ss = [yi - _mm(xi, wi, resid_kind) for xi, yi, wi in zip(xs, ys, _bcast(w, mesh))]
        ats = _reduce([_mm_t(xi, si, resid_kind) for xi, si in zip(xs, ss)], mesh)
        ssum = _reduce([si.sum(dim=0) for si in ss], mesh)
        r = ats - torch.outer(mu_a, ssum) - reg * w
        return r, torch.linalg.vector_norm(r)

    r, n0 = resid(w)
    final_n = n0
    for _ in range(int(refine_steps)):
        w = w + torch.cholesky_solve(r, factor)
        r, final_n = resid(w)
    if kind == "ieee_fp32":
        return w, mu_a, mu_b

    floor = 1e-5 * (torch.linalg.vector_norm(atb_c) + reg * torch.linalg.vector_norm(w))
    final_v, n0_v, floor_v = torch.stack([final_n, n0, floor]).tolist()
    centered_solve_refined.guard_checks += 1
    if not (final_v > 0.5 * n0_v and n0_v > floor_v):
        return w, mu_a, mu_b
    centered_solve_refined.guard_fired += 1
    del factor, r
    w, factor, _, _, _ = _centered_factor(xs, ys, n, reg, "ieee_fp32", mesh)
    for _ in range(int(refine_steps)):
        r, _ = resid(w)
        w = w + torch.cholesky_solve(r, factor)
    return w, mu_a, mu_b


centered_solve_refined.guard_checks = 0
centered_solve_refined.guard_fired = 0


def check_finite(w: torch.Tensor, context: str) -> None:
    """Raise when a solve produced non-finite weights (an unregularized
    solve of a singular system). Callers gate it on ``reg == 0``, the only
    singular-risk case, so regularized fits pay no device read-back."""
    if not bool(torch.isfinite(w.sum())):
        raise FloatingPointError(
            f"{context}: solution contains non-finite values — the normal "
            "equations are singular (more features than examples, or "
            "linearly dependent features) and no regularization was "
            "applied. Pass reg > 0."
        )


# ---------------------------------------------------------------------- BCD


def bcd_from_gram(
    gc: torch.Tensor,
    cc: torch.Tensor,
    reg: float,
    num_epochs: int,
    block_size: int,
) -> torch.Tensor:
    """Feature-block Gauss-Seidel least squares driven by the centered
    Gram statistics — the same per-block update and block order as
    :func:`block_coordinate_descent`. ``gc`` is (d_pad, d_pad) with d_pad
    a multiple of ``block_size``; returns (d_pad, k) weights. Each
    block's factor is formed on the first pass and kept for the later
    ones (:class:`_BlockFactors`)."""
    d = gc.shape[0]
    k = cc.shape[1]
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    eye = torch.eye(block_size, dtype=gc.dtype, device=gc.device)
    w = torch.zeros(d, k, dtype=gc.dtype, device=gc.device)
    factors = _BlockFactors(num_epochs, d // block_size, block_size, gc.dtype, gc.device)

    def step(start, stop):
        g_rows = gc[start:stop]
        g_bb = g_rows[:, start:stop]
        # A_bᵀ(Y − P + A_b W_b) in statistics:
        #   (AᵀY)_b − (AᵀA·W)_b + A_bᵀA_b·W_b
        rhs = cc[start:stop] - mm(g_rows, w) + mm(g_bb, w[start:stop])
        factor = factors.get(start)
        if factor is None:
            factor = _form_factor(factors, start, g_bb, reg, eye)
        else:
            _bcd_step("factor_reuse")
        with _spans.span("bcd:solve"):
            return torch.cholesky_solve(rhs, factor)

    for _ in range(int(num_epochs)):
        for start in range(0, d, block_size):
            stop = start + block_size
            w[start:stop] = factors.run(lambda: step(start, stop))
            _bcd_step("block_update")
    return w


def _bcd_step(step: str) -> None:
    """Count one step of a block coordinate descent
    (``keystone_bcd_steps_total``): ``gram``, ``factor``,
    ``factor_reuse`` (a block update that solved with a kept factor) or
    ``block_update``."""
    _names.metric(_names.BCD_STEPS).inc(step=step)


def _free_device_bytes(device: torch.device) -> Optional[int]:
    """Bytes a solve may still allocate on ``device``: the free bytes
    ``torch.cuda.mem_get_info`` reports plus those the caching allocator
    has reserved and does not use. None off a card: the host's memory is
    not budgeted."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free) + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


class _BlockFactors:
    """The block Cholesky factors of one block coordinate descent, kept
    from the first pass for the later ones.

    A block's A_bᵀA_b + λI does not change between passes, only the
    residual does. So a solve of more than one pass forms each block's
    Gram and factor on the first pass, keeps the factor (on the device
    the reduced Gram lands on, keyed by block) and solves every later
    pass with it. The factors belong to one call of the solver and go
    when it returns.

    They are kept only when the solve has more than one pass and all of
    them (``num_blocks`` · block² · itemsize) fit in the device's free
    memory (:func:`_free_device_bytes`) less one block's workspace: its
    Gram, the regularised copy, the factor being formed and
    ``workspace`` bytes more (a panel the step makes). Otherwise every
    pass forms its own, as a one-pass solve does. :meth:`run` is the
    fallback for a device that runs out all the same: an out-of-memory
    error in a block step while factors are held drops them all and runs
    the step again forming per pass, before an estimator's degradation
    ladder would halve the block."""

    def __init__(self, num_epochs: int, num_blocks: int, block_size: int, dtype, device, workspace: int = 0):
        self._kept = {}
        self.enabled = int(num_epochs) > 1
        if self.enabled:
            need = (int(num_blocks) + 3) * block_size * block_size * dtype.itemsize + int(workspace)
            free = _free_device_bytes(torch.device(device))
            self.enabled = free is None or need <= free

    def get(self, key) -> Optional[torch.Tensor]:
        """The kept factor of block ``key``, or None."""
        return self._kept.get(key)

    def keep(self, key, factor: torch.Tensor) -> None:
        if self.enabled:
            self._kept[key] = factor

    def run(self, step: Callable[[], Any]) -> Any:
        """``step()``; on an out-of-memory error while factors are held,
        drop them, stop keeping any and run ``step()`` once more."""
        try:
            return step()
        except Exception as exc:
            if not (self._kept and is_oom(exc)):
                raise
        # Outside the handler: the failed attempt's frames are gone.
        self._kept.clear()
        self.enabled = False
        return step()


def _form_factor(factors: Optional[_BlockFactors], key, g: torch.Tensor, reg: float, eye: torch.Tensor) -> torch.Tensor:
    """The Cholesky factor of ``g + reg·I``, counted, and offered to
    ``factors`` (when given) for the block's later passes."""
    with _spans.span("bcd:factor"):
        factor = _cholesky(g + reg * eye)
    _bcd_step("factor")
    if factors is not None:
        factors.keep(key, factor)
    return factor


def _bcd_block_update(a_bs, ys, ps, w_b, reg, eye, mesh=None, axes=None, block=None, pass_=None, factors=None):
    """One Gauss-Seidel block update: solve (A_bᵀA_b + λI) W_b' =
    A_bᵀ(Y − P + A_b W_b) and move the predictions P by A_b(W_b' − W_b).
    ``a_bs`` / ``ys`` / ``ps`` are the row shards of the block panel, the
    labels and the predictions (one each without a mesh); the Gram and the
    right-hand side are summed over ``axes`` (default: the row axes), the
    block solve runs once. Returns ``(W_b', P')``.

    ``factors`` (a :class:`_BlockFactors`, keyed by ``block``) holds the
    factors the block's earlier passes kept: with one there the Gram and
    the factorisation are skipped, and a factor formed here is offered to
    it. Without it every call forms both and holds the factor no longer
    than its solve.

    One ``bcd:block`` span (attributes ``block`` and ``pass``, the
    callers' loop indices, ``rows``, ``width`` and ``reused``, whether a
    kept factor was used) holds a span for each step: ``bcd:rhs`` (the
    residual, then its product with the block), ``bcd:gram`` and
    ``bcd:factor`` (when formed), ``bcd:solve`` and ``bcd:update`` (the
    predictions). The Gram, the factor, a kept factor's use
    (``factor_reuse``) and the update are counted."""
    rows = sum(int(a_b.shape[0]) for a_b in a_bs)
    factor = factors.get(block) if factors is not None else None
    reused = factor is not None
    with _spans.span("bcd:block", block=block, rows=rows, width=int(a_bs[0].shape[1]), reused=reused,
                     **{"pass": pass_}):
        with _spans.span("bcd:rhs"):
            w_bs = _bcast(w_b, mesh)
            rs = [y - p + mm(a_b, w) for a_b, y, p, w in zip(a_bs, ys, ps, w_bs)]
        if not reused:
            with _spans.span("bcd:gram"):
                g = _reduce([mm_t(a_b, a_b) for a_b in a_bs], mesh, axes)
            _bcd_step("gram")
        with _spans.span("bcd:rhs"):
            c = _reduce([mm_t(a_b, r) for a_b, r in zip(a_bs, rs)], mesh, axes)
        if reused:
            _bcd_step("factor_reuse")
        else:
            factor = _form_factor(factors, block, g, reg, eye)
        with _spans.span("bcd:solve"):
            w_b_new = torch.cholesky_solve(c, factor)
        del factor  # a kept one lives on in `factors`; no other is held through the update
        with _spans.span("bcd:update"):
            new_bs = _bcast(w_b_new, mesh)
            ps = [p + mm(a_b, wn - w) for p, a_b, wn, w in zip(ps, a_bs, new_bs, w_bs)]
        _bcd_step("block_update")
    return w_b_new, ps


def block_coordinate_descent(
    a: torch.Tensor,
    y: torch.Tensor,
    reg: float,
    num_epochs: int,
    block_size: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Least-squares block coordinate descent over feature blocks: per
    block b, solve (A_bᵀA_b + λI) W_b = A_bᵀ (Y − P + A_b W_b), where P
    are the current predictions. ``a`` is (n, d) with d a multiple of
    ``block_size`` (zero pad rows allowed), ``y`` is (n, k); either may be
    a row-:class:`Sharded` value. Over a ``mesh`` with several row shards
    each shard keeps its rows' predictions and the per-block Gram and
    right-hand side are summed across shards. Returns the (d, k)
    weights."""
    mesh = _row_mesh(a, mesh)
    a_s, y_s = _row_shards(a, mesh), _row_shards(y, mesh)
    d = a_s[0].shape[1]
    k = y_s[0].shape[1]
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    eye = torch.eye(block_size, dtype=a_s[0].dtype, device=a_s[0].device)
    w = torch.zeros(d, k, dtype=a_s[0].dtype, device=a_s[0].device)
    ps = [torch.zeros_like(t) for t in y_s]
    factors = _BlockFactors(num_epochs, d // block_size, block_size, a_s[0].dtype, a_s[0].device)
    for epoch in range(int(num_epochs)):
        for start in range(0, d, block_size):
            stop = start + block_size
            w[start:stop], ps = factors.run(lambda: _bcd_block_update(
                [t[:, start:stop] for t in a_s], y_s, ps, w[start:stop], reg, eye, mesh,
                block=start // block_size, pass_=epoch, factors=factors,
            ))
    return w


def block_coordinate_descent_rematerialized(
    block_fn: Callable[[int, int, int], torch.Tensor],
    y: torch.Tensor,
    reg: float,
    num_epochs: int,
    block_size: int,
    num_blocks: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """BCD where each feature block is COMPUTED when its update runs
    instead of read from anywhere — for feature matrices too large for the
    card and for host RAM (TIMIT-wide at full n is 144 GB).

    The same per-block update as :func:`block_coordinate_descent`.
    ``block_fn(b, row_offset, rows)`` returns the (rows, block_size) panel
    of block ``b`` for the rows starting at ``row_offset``, on the
    shard's device: on one device always ``row_offset = 0`` and ``rows =
    y.shape[0]``; over a ``mesh`` once per row shard, with that shard's
    offset into the padded rows. Only one panel per shard and the (n, k)
    predictions are resident. Returns the (num_blocks·block_size, k)
    weights."""
    mesh = _row_mesh(y, mesh)
    y_s = _row_shards(y, mesh)
    rows, k = y_s[0].shape
    offsets = [0] if mesh is None else [i * rows for i in axis_index(mesh, row_axes(mesh))]
    dtype, device = y_s[0].dtype, y_s[0].device
    eye = torch.eye(block_size, dtype=dtype, device=device)
    w = torch.zeros(num_blocks * block_size, k, dtype=dtype, device=device)
    ps = [torch.zeros_like(t) for t in y_s]
    factors = _BlockFactors(num_epochs, num_blocks, block_size, dtype, device,
                            workspace=len(y_s) * rows * block_size * dtype.itemsize)

    def step(b: int, epoch: int):
        a_bs = []
        for offset, yi in zip(offsets, y_s):
            a_b = block_fn(b, offset, rows)
            if tuple(a_b.shape) != (rows, block_size) or a_b.device != yi.device:
                raise ValueError(
                    f"block_fn({b}, {offset}) gave {tuple(a_b.shape)} on {a_b.device}; "
                    f"expected ({rows}, {block_size}) on {yi.device}"
                )
            a_bs.append(a_b)
        start = b * block_size
        return _bcd_block_update(
            a_bs, y_s, ps, w[start : start + block_size], reg, eye, mesh, block=b, pass_=epoch, factors=factors
        )

    for epoch in range(int(num_epochs)):
        for b in range(int(num_blocks)):
            start = b * block_size
            w[start : start + block_size], ps = factors.run(lambda: step(b, epoch))
    return w


def block_coordinate_descent_streaming(
    x_host,
    y,
    reg: float,
    num_epochs: int,
    block_size: int,
    num_examples: Optional[int] = None,
    center: bool = True,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
):
    """BCD least squares for feature matrices too large for the card.

    ``x_host`` (a CPU tensor or numpy array, (n, d)) stays in host RAM; per
    block update its (n, block_size) column slice is gathered into one
    pinned host buffer and uploaded, then centred on the device under the
    row mask (the first ``num_examples`` rows are real), so device
    residency is one panel + the (n, k) predictions, independent of d.
    The short last block is zero-padded. Feature means come from one
    float64 host pass. Fits on ``device`` (default CUDA); ``y`` is (n, k).
    Over a ``mesh`` with several row shards the rows are zero-padded to a
    shard multiple and each uploaded panel is split into row shards (views
    on the upload's device), updated as :func:`block_coordinate_descent`
    does.

    Returns ``(w, mu_a, mu_b)``: weights (d, k) and the feature/label
    means used for centering (zeros when ``center=False``). Each call adds
    its uploaded panels to ``block_coordinate_descent_streaming.blocks_uploaded``
    and their bytes to ``.bytes_uploaded``.

    Uploads do not overlap the block updates yet."""
    device = resolve_device(device)
    x_host = torch.as_tensor(x_host)
    if x_host.device.type != "cpu" or x_host.ndim != 2:
        raise ValueError(f"x_host must be a 2-D host matrix; got {tuple(x_host.shape)} on {x_host.device}")
    n_rows, d = x_host.shape
    n = num_examples if num_examples is not None else n_rows
    y_dev = torch.as_tensor(y).to(device=device, dtype=torch.float32)
    k = y_dev.shape[1]
    bs = min(block_size, d)
    num_blocks = -(-d // bs)
    mesh = None if mesh is None or row_shard_count(mesh) <= 1 else mesh
    n_pad = n_rows if mesh is None else -(-n_rows // row_shard_count(mesh)) * row_shard_count(mesh)

    if center:
        mu_a = (x_host[:n].sum(dim=0, dtype=torch.float64) / n).to(torch.float32).to(device)
        mu_b = y_dev[:n].sum(dim=0) / n
        y_dev = y_dev - mu_b
        y_dev[n:] = 0.0
    else:
        mu_a = torch.zeros(d, device=device)
        mu_b = torch.zeros(k, device=device)
    if mesh is not None:
        y_dev = _pad_rows(y_dev, row_shard_count(mesh))
    mask = torch.zeros(n_pad, 1, device=device)
    mask[:n] = 1.0
    mu_pad = torch.nn.functional.pad(mu_a, (0, num_blocks * bs - d))

    staging = torch.empty(n_pad, bs, dtype=torch.float32, pin_memory=device.type == "cuda")
    staging[n_rows:].zero_()  # shard padding rows: zero in every panel
    eye = torch.eye(bs, device=device)
    w = torch.zeros(num_blocks * bs, k, device=device)
    y_s = _row_shards(y_dev, mesh)
    ps = [torch.zeros_like(t) for t in y_s]
    # The factors stay on the card; the panels are uploaded every pass.
    factors = _BlockFactors(num_epochs, num_blocks, bs, torch.float32, device, workspace=staging.nbytes)

    def step(b: int, epoch: int):
        start = b * bs
        width = min(bs, d - start)
        staging[:n_rows, :width].copy_(x_host[:, start : start + width])
        if width < bs:
            staging[:n_rows, width:].zero_()
        panel = staging.to(device, copy=True)
        block_coordinate_descent_streaming.blocks_uploaded += 1
        block_coordinate_descent_streaming.bytes_uploaded += panel.numel() * panel.element_size()
        a_b = panel.sub_(mu_pad[start : start + bs]).mul_(mask)
        return _bcd_block_update(
            _row_shards(a_b, mesh), y_s, ps, w[start : start + bs], reg, eye, mesh,
            block=b, pass_=epoch, factors=factors,
        )

    for epoch in range(int(num_epochs)):
        for b in range(num_blocks):
            w[b * bs : (b + 1) * bs], ps = factors.run(lambda: step(b, epoch))
    return w[:d], mu_a, mu_b


block_coordinate_descent_streaming.blocks_uploaded = 0
block_coordinate_descent_streaming.bytes_uploaded = 0


# ------------------------------------------------------------------- 2-D BCD


def prepare_block_sharded(a, mesh: Optional[Mesh] = None, fine_rows: bool = False) -> Sharded:
    """Lay a matrix out for the 2-D (``data`` × ``model``) solver path,
    rows zero-padded to a multiple of row shards × model shards.

    ``fine_rows=False``: rows over the row axes, columns over ``model`` —
    the layout for A: shard (i, j) holds the (n/D, d/M) tile, so A is
    never column-replicated. ``fine_rows=True``: rows over (row axes,
    ``model``) jointly, columns whole — the layout for Y and the carried
    predictions, M× finer row shards than the 1-D path. On ``a``'s own
    device every tile is a view."""
    if isinstance(a, Sharded):
        return a
    mesh = mesh or get_mesh()
    a = torch.as_tensor(a)
    a = _pad_rows(a, row_shard_count(mesh) * model_axis_size(mesh))
    if fine_rows:
        return shard_tensor(a, mesh, P(row_axes(mesh) + (MODEL_AXIS,)))
    return shard_tensor(a, mesh, P(row_axes(mesh), MODEL_AXIS))


def block_coordinate_descent_2d(
    a,
    y,
    reg: float,
    num_epochs: int,
    block_size: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Gauss-Seidel feature-block coordinate descent on a 2-D (``data``,
    ``model``) mesh — the JAX package's ``block_coordinate_descent_2d``:

    - A is (row, model)-tiled (:func:`prepare_block_sharded`), so shard
      (i, j) holds rows i and the columns of model group j's blocks;
    - the carried predictions are (n/(D·M), k) per shard
      (``fine_rows=True``), M× smaller than the 1-D path's;
    - per local block index, one ``all_to_all`` over ``model`` re-shards
      the M groups' (n/D, b) blocks into (n/(D·M), b) fine-row tiles on
      every shard, so each block's Gram is summed over the whole mesh
      (``allreduce_sum`` over (row axes, ``model``)); the owner group's
      block weights reach the others by an ``allreduce_sum`` over
      ``model`` of (own weights, zeros elsewhere).

    Block order is (local block, model group)-major — a fixed permutation
    of the 1-D order with the same fixed point (AᵀA + λI)W = AᵀY. d must
    divide into M·block_size. Returns the (d, k) weights, the model
    groups' blocks concatenated. With fewer than two model shards this is
    :func:`block_coordinate_descent`."""
    mesh = mesh or get_mesh()
    m = model_axis_size(mesh)
    if m < 2:
        return block_coordinate_descent(a, y, reg, num_epochs, block_size, mesh)
    a_s = prepare_block_sharded(a, mesh).shards
    y_s = prepare_block_sharded(y, mesh, fine_rows=True).shards
    d_loc = a_s[0].shape[1]
    if d_loc % block_size != 0:
        raise ValueError(f"d={d_loc * m} not divisible by model_axis·block_size={m}·{block_size}")
    k = y_s[0].shape[1]
    all_axes = row_axes(mesh) + (MODEL_AXIS,)
    j_of = axis_index(mesh, MODEL_AXIS)
    dtype, device = a_s[0].dtype, a_s[0].device
    eye = torch.eye(block_size, dtype=dtype, device=device)
    # Each shard's copy of its model group's weights, as in the JAX body.
    w_local = [torch.zeros(d_loc, k, dtype=dtype, device=t.device) for t in a_s]
    ps = [torch.zeros_like(t) for t in y_s]
    factors = _BlockFactors(num_epochs, m * (d_loc // block_size), block_size, dtype, device)

    def step(refined, start: int, jp: int, epoch: int):
        stop = start + block_size
        a_j = [t[:, jp * block_size : (jp + 1) * block_size] for t in refined]
        rows = sum(int(ai.shape[0]) for ai in a_j)
        factor = factors.get((start, jp))
        reused = factor is not None
        with _spans.span("bcd:block", block=jp * (d_loc // block_size) + start // block_size,
                         rows=rows, width=block_size, reused=reused, **{"pass": epoch}):
            with _spans.span("bcd:rhs"):
                # Broadcast the owner group's current block weights.
                w_old = allreduce_sum(
                    [wl[start:stop] if j == jp else torch.zeros_like(wl[start:stop])
                     for wl, j in zip(w_local, j_of)],
                    mesh, MODEL_AXIS,
                )
                rs = [yi - p + mm(ai, wo) for yi, p, ai, wo in zip(y_s, ps, a_j, w_old)]
            if not reused:
                with _spans.span("bcd:gram"):
                    g = _reduce([mm_t(ai, ai) for ai in a_j], mesh, all_axes)
                _bcd_step("gram")
            with _spans.span("bcd:rhs"):
                c = _reduce([mm_t(ai, r) for ai, r in zip(a_j, rs)], mesh, all_axes)
            if reused:
                _bcd_step("factor_reuse")
            else:
                factor = _form_factor(factors, (start, jp), g, reg, eye)
            with _spans.span("bcd:solve"):
                w_new = torch.cholesky_solve(c, factor)
            del factor  # a kept one lives on in `factors`; no other is held through the update
            with _spans.span("bcd:update"):
                new_s = _bcast(w_new, mesh)
                new_ps = [p + mm(ai, wn - wo) for p, ai, wn, wo in zip(ps, a_j, new_s, w_old)]
        return new_s, new_ps

    for epoch in range(int(num_epochs)):
        for start in range(0, d_loc, block_size):
            refined = all_to_all([t[:, start : start + block_size] for t in a_s], mesh, MODEL_AXIS,
                                 split_axis=0, concat_axis=1)
            for jp in range(m):
                new_s, ps = factors.run(lambda: step(refined, start, jp, epoch))
                for wl, j, wn in zip(w_local, j_of, new_s):
                    if j == jp:
                        wl[start : start + block_size] = wn
                _bcd_step("block_update")
    # Data row 0's copy of each model group's weights, in group order.
    return torch.cat([_to(w_local[j], mesh.flat_devices[0]) for j in range(m)])


def block_sharded_apply(x, w: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Predictions of a column-sharded X against a model-sharded W: each
    shard's partial product X_ij·W_j, summed over ``model`` by
    ``allreduce_sum`` (the reference's sum of per-block predictions,
    BlockLinearMapper.scala:50-73, as a collective). Returns the (n, k)
    predictions of the padded rows. With fewer than two model shards,
    one product."""
    mesh = mesh or get_mesh()
    if model_axis_size(mesh) < 2 or (not isinstance(x, Sharded) and x.device.type == "meta"):
        return mm(x.assemble() if isinstance(x, Sharded) else x, w)
    x_s = prepare_block_sharded(x, mesh)
    w_s = shard_tensor(w, mesh, P(MODEL_AXIS))
    partial = [mm(xi, wi) for xi, wi in zip(x_s.shards, w_s.shards)]
    out = allreduce_sum(partial, mesh, MODEL_AXIS)
    rows = x_s.shape[0]
    return Sharded(out, P(row_axes(mesh)), mesh, (rows, w.shape[1])).assemble()


__all__ = [
    "ROW_CHUNK",
    "addmm_t_",
    "bcd_from_gram",
    "block_coordinate_descent",
    "block_coordinate_descent_2d",
    "block_coordinate_descent_rematerialized",
    "block_coordinate_descent_streaming",
    "block_sharded_apply",
    "centered_solve_refined",
    "check_finite",
    "gram",
    "gram_stream_block_step",
    "gram_stream_finish",
    "gram_stream_init",
    "gram_stream_step",
    "mm",
    "mm_t",
    "model_axis_size",
    "normal_equations_solve",
    "prepare_block_sharded",
    "prepare_row_sharded",
    "precision",
    "precision_for_mode",
    "set_solver_mode_override",
    "solve_from_gram",
    "solve_spd",
    "solver_mode",
    "solver_mode_scope",
    "tsqr_r",
    "tsqr_svd",
]
