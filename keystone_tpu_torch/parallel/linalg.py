"""Dense linear algebra for the least-squares solvers, on one device.

Port of the ``keystone_tpu/parallel/linalg.py`` subset the solvers use:
``mm``, the streaming Gram statistics (``gram_stream_init`` /
``gram_stream_step`` / ``gram_stream_finish``), ``solve_spd``,
``solve_from_gram``, ``centered_solve_refined``, ``check_finite``,
``bcd_from_gram``, ``block_coordinate_descent`` and the solver precision
modes (``solver_mode`` / ``solver_mode_scope``). The JAX package leaves
these dense products and factorisations to XLA; here they are
``torch.matmul`` (cuBLAS) and ``torch.linalg.cholesky`` /
``torch.cholesky_solve`` (cuSOLVER). Its ``lax.scan`` over blocks is a
Python loop, and its ``shard_map``/``psum`` collapse to one device.

Precision: the reference runs these at ``lax.Precision.HIGHEST`` (full
fp32). TF32 is switched off for matmuls and cuDNN when this module is
imported, so fp32 products on the card are IEEE fp32. Every
``KEYSTONE_SOLVER_PRECISION`` mode runs IEEE fp32 here: ``highest`` and
``refine`` as in the reference (``refine`` adds its two refinement
steps), and ``high`` and ``default`` too, for now — mapping those two to
TF32 or split-bf16 products is later work. The process-wide TF32 flags
are never switched per call: a serving worker thread shares them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..envknobs import env_raw

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-fp32 matrix product."""
    return torch.matmul(a, b)


#: Rows per partial product in :func:`mm_t`.
ROW_CHUNK = 4096


def mm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ·b, contracting the example axis in chunks of ``ROW_CHUNK`` rows
    whose products are summed. cuBLAS accumulates one long fp32 run over
    the contraction; over 65,536 centered rows that put the in-core fit's
    scores 1.7e-4 (relative) from a float64 fit on an H100
    (chip_smoke.py), where the block-sparse path's were 6.3e-7."""
    n = a.shape[0]
    out = mm(a[:ROW_CHUNK].T, b[:ROW_CHUNK])
    for start in range(ROW_CHUNK, n, ROW_CHUNK):
        out.addmm_(a[start : start + ROW_CHUNK].T, b[start : start + ROW_CHUNK])
    return out


def addmm_t_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out += aᵀ·b`` in place, one ``ROW_CHUNK``-row partial product at
    a time (the contraction :func:`mm_t` makes, accumulated into an
    existing sum)."""
    for start in range(0, a.shape[0], ROW_CHUNK):
        out.addmm_(a[start : start + ROW_CHUNK].T, b[start : start + ROW_CHUNK])
    return out


# ------------------------------------------------------------ precision modes

#: ``KEYSTONE_SOLVER_PRECISION`` modes. All four run IEEE fp32 in the port
#: (module docstring); ``refine`` also selects the exact solver's
#: iterative refinement.
_PRECISION_MODES = ("highest", "high", "default", "refine")

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


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; raises on a matrix that is not positive
    definite (the JAX reference would return NaNs silently)."""
    return torch.linalg.cholesky(a)


def solve_spd(ata: torch.Tensor, atb: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (AᵀA + reg·I) x = Aᵀb by Cholesky."""
    d = ata.shape[0]
    lhs = ata + reg * torch.eye(d, dtype=ata.dtype, device=ata.device)
    return torch.cholesky_solve(atb, _cholesky(lhs))


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
    (:func:`addmm_t_`), for :func:`mm_t`'s reason. Pad rows must be
    exactly zero (the streaming engine re-zeroes them)."""
    g, c, sa, sb = carry
    x = x.to(g.dtype)
    y = y.to(g.dtype)
    addmm_t_(g, x, x)
    addmm_t_(c, x, y)
    sa.add_(x.sum(dim=0))
    sb.add_(y.sum(dim=0))
    return carry


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


def centered_solve_refined(
    x: torch.Tensor,
    y: torch.Tensor,
    n: int,
    reg: float,
    refine_steps: int = 0,
):
    """Centered ridge solve ``(w, μ_a, μ_b)``: the Gram and column sums of
    ``x`` / ``y`` (zero pad rows allowed; ``n`` is the real row count),
    algebraic centering (Σ(a−μ)(a−μ)ᵀ = AᵀA − n·μμᵀ, no centered copy)
    and a Cholesky solve, then ``refine_steps`` steps of iterative
    refinement against the TRUE residual of the centered system,
    computed from ``x`` itself with S = Y − X·W:

        A_cᵀ(B_c − A_c·W) − λW = XᵀS − μ_a·(1ᵀS) − λW

    each step reusing the factor. The JAX package's divergence guard
    re-solves from a HIGHEST-precision Gram when a fast Gram made the
    steps diverge; here the Gram is always IEEE fp32 (every precision
    mode), so there is nothing to fall back to."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d = x.shape[1]
    mu_a = x.sum(dim=0) / n
    mu_b = y.sum(dim=0) / n
    ata_c = mm_t(x, x) - n * torch.outer(mu_a, mu_a)
    atb_c = mm_t(x, y) - n * torch.outer(mu_a, mu_b)
    factor = _cholesky(ata_c + reg * torch.eye(d, dtype=x.dtype, device=x.device))
    w = torch.cholesky_solve(atb_c, factor)
    for _ in range(int(refine_steps)):
        s = y - mm(x, w)
        r = mm_t(x, s) - torch.outer(mu_a, s.sum(dim=0)) - reg * w
        w = w + torch.cholesky_solve(r, factor)
    return w, mu_a, mu_b


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
            a_b = a[:, start:stop]
            w_b = w[start:stop]
            r = y - p + mm(a_b, w_b)
            g = mm_t(a_b, a_b)
            c = mm_t(a_b, r)
            w_b_new = torch.cholesky_solve(c, _cholesky(g + reg * eye))
            p = p + mm(a_b, w_b_new - w_b)
            w[start:stop] = w_b_new
    return w


__all__ = [
    "addmm_t_",
    "bcd_from_gram",
    "block_coordinate_descent",
    "centered_solve_refined",
    "check_finite",
    "gram_stream_finish",
    "gram_stream_init",
    "gram_stream_step",
    "mm",
    "mm_t",
    "set_solver_mode_override",
    "solve_from_gram",
    "solve_spd",
    "solver_mode",
    "solver_mode_scope",
]
