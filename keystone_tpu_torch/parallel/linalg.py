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
Python loop here, and its ``shard_map``/``psum`` collapse to one device;
the sharded and 2-D variants are not ported yet.

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
from typing import Callable, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..envknobs import env_raw
from ..ops.cuda import gemm as _gemm

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


def _mm(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return torch.matmul(a, b)
    return _gemm.gemm(a, b, kind)


def _addmm_t_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (out, a, b)):
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


# ------------------------------------------------------------- gram / solve


def gram(
    a,
    b: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(AᵀA, AᵀB) — AᵀB is None without ``b``. Zero-padded rows
    contribute nothing.

    ``a`` may be a host-side
    :class:`~keystone_tpu_torch.utils.sparse.BlockSparseMatrix`: the Gram
    then comes from ``bsr_gram_totals`` (the ELL kernel on a card), on
    ``b``'s device, or on ``device`` without ``b``."""
    from ..utils.sparse import BlockSparseMatrix

    if isinstance(a, BlockSparseMatrix):
        from ..ops.cuda.blocksparse import bsr_gram_totals

        y = b if b is not None else torch.zeros(a.shape[0], 1, device=resolve_device(device))
        g, c, _sa, _sb = bsr_gram_totals(a, y)
        return g, (None if b is None else c)
    return mm_t(a, a), (None if b is None else mm_t(a, b))


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; raises on a matrix that is not positive
    definite (the JAX reference would return NaNs silently)."""
    return torch.linalg.cholesky(a)


def solve_spd(ata: torch.Tensor, atb: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (AᵀA + reg·I) x = Aᵀb by Cholesky."""
    d = ata.shape[0]
    lhs = ata + reg * torch.eye(d, dtype=ata.dtype, device=ata.device)
    return torch.cholesky_solve(atb, _cholesky(lhs))


def normal_equations_solve(a: torch.Tensor, b: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """One-shot least squares: x = (AᵀA + λI)⁻¹ Aᵀb."""
    ata, atb = gram(a, b)
    return solve_spd(ata, atb, reg=reg)


def tsqr_r(a: torch.Tensor) -> torch.Tensor:
    """R factor of a tall-skinny matrix (mlmatrix ``TSQR``). On one device
    the JAX package's per-shard QR and QR of the stacked factors is one
    QR of ``a``."""
    return torch.linalg.qr(a, mode="r")[1]


def tsqr_svd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Singular values and right singular vectors (Vᵀ) of ``a`` via the
    SVD of its TSQR R factor: A = QR, R = UΣVᵀ ⇒ A's (Σ, V) are R's."""
    _, s, vt = torch.linalg.svd(tsqr_r(a), full_matrices=False)
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


def _centered_factor(x, y, n, reg, kind, perturb=0.0):
    """Gram at ``kind`` (plus the test seam's ``perturb``) → centering →
    Cholesky: ``(w, factor, atb_c, μ_a, μ_b)``."""
    d = x.shape[1]
    mu_a = x.sum(dim=0) / n
    mu_b = y.sum(dim=0) / n
    ata = _mm_t(x, x, kind)
    atb = _mm_t(x, y, kind)
    if perturb:
        ata = ata + perturb * (torch.trace(ata) / d) * torch.ones_like(ata)
    ata_c = ata - n * torch.outer(mu_a, mu_a)
    atb_c = atb - n * torch.outer(mu_a, mu_b)
    factor = _cholesky(ata_c + reg * torch.eye(d, dtype=x.dtype, device=x.device))
    return torch.cholesky_solve(atb_c, factor), factor, atb_c, mu_a, mu_b


def centered_solve_refined(
    x: torch.Tensor,
    y: torch.Tensor,
    n: int,
    reg: float,
    gram_precision: Optional[str] = None,
    refine_steps: int = 0,
    resid_precision: str = "highest",
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

    and corrects W through the same factor.

    Divergence guard (when ``refine_steps > 0`` and the Gram is not IEEE
    fp32): refinement contracts the error by about cond(Gram)·ε_gram per
    step, so on a badly conditioned system it can stall or diverge. The
    final iterate's residual norm is measured, and when it is not at most
    half the initial one — and the initial one is above the roundoff
    floor 1e-5·(‖A_cᵀB_c‖ + λ‖W‖) — the solve is redone from an IEEE fp32
    Gram with the same steps. The decision reads two norms back to the
    host once; ``centered_solve_refined.guard_checks`` and
    ``.guard_fired`` count the decisions and the fallbacks."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    kind = precision_for_mode(gram_precision or solver_mode())
    resid_kind = precision_for_mode(resid_precision)
    w, factor, atb_c, mu_a, mu_b = _centered_factor(x, y, n, reg, kind, _TEST_GRAM_PERTURB)
    if refine_steps == 0:
        return w, mu_a, mu_b

    def resid(w):
        s = y - _mm(x, w, resid_kind)
        r = _mm_t(x, s, resid_kind) - torch.outer(mu_a, s.sum(dim=0)) - reg * w
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
    w, factor, _, _, _ = _centered_factor(x, y, n, reg, "ieee_fp32")
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
    a multiple of ``block_size``; returns (d_pad, k) weights."""
    d = gc.shape[0]
    k = cc.shape[1]
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    eye = torch.eye(block_size, dtype=gc.dtype, device=gc.device)
    w = torch.zeros(d, k, dtype=gc.dtype, device=gc.device)
    for _ in range(int(num_epochs)):
        for start in range(0, d, block_size):
            stop = start + block_size
            g_rows = gc[start:stop]
            g_bb = g_rows[:, start:stop]
            w_b = w[start:stop]
            # A_bᵀ(Y − P + A_b W_b) in statistics:
            #   (AᵀY)_b − (AᵀA·W)_b + A_bᵀA_b·W_b
            rhs = cc[start:stop] - mm(g_rows, w) + mm(g_bb, w_b)
            w[start:stop] = torch.cholesky_solve(rhs, _cholesky(g_bb + reg * eye))
    return w


def _bcd_block_update(a_b, y, p, w_b, reg, eye):
    """One Gauss-Seidel block update: solve (A_bᵀA_b + λI) W_b' =
    A_bᵀ(Y − P + A_b W_b) and move the predictions P by A_b(W_b' − W_b).
    Returns ``(W_b', P')``."""
    r = y - p + mm(a_b, w_b)
    g = mm_t(a_b, a_b)
    c = mm_t(a_b, r)
    w_b_new = torch.cholesky_solve(c, _cholesky(g + reg * eye))
    return w_b_new, p + mm(a_b, w_b_new - w_b)


def block_coordinate_descent(
    a: torch.Tensor,
    y: torch.Tensor,
    reg: float,
    num_epochs: int,
    block_size: int,
) -> torch.Tensor:
    """Least-squares block coordinate descent over feature blocks: per
    block b, solve (A_bᵀA_b + λI) W_b = A_bᵀ (Y − P + A_b W_b), where P
    are the current predictions. ``a`` is (n, d) with d a multiple of
    ``block_size`` (zero pad rows allowed), ``y`` is (n, k). Returns the
    (d, k) weights."""
    n, d = a.shape
    k = y.shape[1]
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    eye = torch.eye(block_size, dtype=a.dtype, device=a.device)
    w = torch.zeros(d, k, dtype=a.dtype, device=a.device)
    p = torch.zeros_like(y)
    for _ in range(int(num_epochs)):
        for start in range(0, d, block_size):
            stop = start + block_size
            w[start:stop], p = _bcd_block_update(a[:, start:stop], y, p, w[start:stop], reg, eye)
    return w


def block_coordinate_descent_rematerialized(
    block_fn: Callable[[int, int, int], torch.Tensor],
    y: torch.Tensor,
    reg: float,
    num_epochs: int,
    block_size: int,
    num_blocks: int,
) -> torch.Tensor:
    """BCD where each feature block is COMPUTED when its update runs
    instead of read from anywhere — for feature matrices too large for the
    card and for host RAM (TIMIT-wide at full n is 144 GB).

    The same per-block update as :func:`block_coordinate_descent`.
    ``block_fn(b, row_offset, rows)`` returns the (rows, block_size) panel
    of block ``b`` for the rows starting at ``row_offset`` — on one device
    always ``row_offset = 0`` and ``rows = y.shape[0]`` — on ``y``'s
    device. Only one panel and the (n, k) predictions are resident.
    Returns the (num_blocks·block_size, k) weights."""
    rows, k = y.shape
    eye = torch.eye(block_size, dtype=y.dtype, device=y.device)
    w = torch.zeros(num_blocks * block_size, k, dtype=y.dtype, device=y.device)
    p = torch.zeros_like(y)
    for _ in range(int(num_epochs)):
        for b in range(int(num_blocks)):
            a_b = block_fn(b, 0, rows)
            if tuple(a_b.shape) != (rows, block_size) or a_b.device != y.device:
                raise ValueError(
                    f"block_fn({b}) gave {tuple(a_b.shape)} on {a_b.device}; "
                    f"expected ({rows}, {block_size}) on {y.device}"
                )
            start = b * block_size
            w[start : start + block_size], p = _bcd_block_update(
                a_b, y, p, w[start : start + block_size], reg, eye
            )
            del a_b
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
):
    """BCD least squares for feature matrices too large for the card.

    ``x_host`` (a CPU tensor or numpy array, (n, d)) stays in host RAM; per
    block update its (n, block_size) column slice is gathered into one
    pinned host buffer and uploaded, then centred on the device under the
    row mask (the first ``num_examples`` rows are real), so device
    residency is one panel + the (n, k) predictions, independent of d.
    The short last block is zero-padded. Feature means come from one
    float64 host pass. Fits on ``device`` (default CUDA); ``y`` is (n, k).

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

    if center:
        mu_a = (x_host[:n].sum(dim=0, dtype=torch.float64) / n).to(torch.float32).to(device)
        mu_b = y_dev[:n].sum(dim=0) / n
        y_dev = y_dev - mu_b
        y_dev[n:] = 0.0
    else:
        mu_a = torch.zeros(d, device=device)
        mu_b = torch.zeros(k, device=device)
    mask = torch.zeros(n_rows, 1, device=device)
    mask[:n] = 1.0
    mu_pad = torch.nn.functional.pad(mu_a, (0, num_blocks * bs - d))

    staging = torch.empty(n_rows, bs, dtype=torch.float32, pin_memory=device.type == "cuda")
    eye = torch.eye(bs, device=device)
    w = torch.zeros(num_blocks * bs, k, device=device)
    p = torch.zeros(n_rows, k, device=device)
    for _ in range(int(num_epochs)):
        for b in range(num_blocks):
            start = b * bs
            width = min(bs, d - start)
            staging[:, :width].copy_(x_host[:, start : start + width])
            if width < bs:
                staging[:, width:].zero_()
            panel = staging.to(device, copy=True)
            block_coordinate_descent_streaming.blocks_uploaded += 1
            block_coordinate_descent_streaming.bytes_uploaded += panel.numel() * panel.element_size()
            a_b = panel.sub_(mu_pad[start : start + bs]).mul_(mask)
            w[start : start + bs], p = _bcd_block_update(a_b, y_dev, p, w[start : start + bs], reg, eye)
            del a_b, panel
    return w[:d], mu_a, mu_b


block_coordinate_descent_streaming.blocks_uploaded = 0
block_coordinate_descent_streaming.bytes_uploaded = 0


__all__ = [
    "ROW_CHUNK",
    "addmm_t_",
    "bcd_from_gram",
    "block_coordinate_descent",
    "block_coordinate_descent_rematerialized",
    "block_coordinate_descent_streaming",
    "centered_solve_refined",
    "check_finite",
    "gram",
    "gram_stream_block_step",
    "gram_stream_finish",
    "gram_stream_init",
    "gram_stream_step",
    "mm",
    "mm_t",
    "normal_equations_solve",
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
