"""Dense linear algebra for the least-squares solvers, on one device.

Port of the ``keystone_tpu/parallel/linalg.py`` subset the block solver
uses: ``mm``, the streaming Gram statistics (``gram_stream_init`` /
``gram_stream_step`` / ``gram_stream_finish``), ``solve_spd``,
``bcd_from_gram`` and ``block_coordinate_descent``. The JAX package
leaves these dense products and factorisations to XLA; here they are
``torch.matmul`` (cuBLAS) and ``torch.linalg.cholesky`` /
``torch.cholesky_solve`` (cuSOLVER). Its ``lax.scan`` over blocks is a
Python loop, and its ``shard_map``/``psum`` collapse to one device.

Precision: the reference runs these at ``lax.Precision.HIGHEST`` (full
fp32). TF32 is switched off for matmuls and cuDNN when this module is
imported, so fp32 products on the card are IEEE fp32.
"""

from __future__ import annotations

import torch

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
    """One chunk's contribution to the sufficient statistics. Pad rows
    must be exactly zero."""
    g, c, sa, sb = carry
    x = x.to(g.dtype)
    y = y.to(g.dtype)
    return (
        g + mm(x.T, x),
        c + mm(x.T, y),
        sa + x.sum(dim=0),
        sb + y.sum(dim=0),
    )


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
    "bcd_from_gram",
    "block_coordinate_descent",
    "gram_stream_finish",
    "gram_stream_init",
    "gram_stream_step",
    "mm",
    "mm_t",
    "solve_spd",
]
