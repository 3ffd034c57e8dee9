"""Block-sparse (BSR) matmul and Gram accumulation.

Port of ``keystone_tpu/ops/pallas/blocksparse.py``. The host-side
:class:`~keystone_tpu_torch.utils.sparse.BlockSparseMatrix` is flattened to
a padded ELL view — ``K`` block slots per block row, unused slots holding
a zero block at column 0 — and multiplied into a dense operand by
:func:`ell_matmul`:

- on CUDA tensors, the hand-written kernel ``csrc/ell_matmul.cu``
  (replacing the Pallas kernel ``_ell_matmul_pallas``), built at first
  use; it raises on what it does not take and never falls back;
- on CPU tensors, :func:`ell_matmul_reference`, the plain PyTorch version
  with the same semantics (the JAX package's ``impl="lax"`` path).

The tensors' device decides; there is no other switch.
:func:`bsr_gram_totals` returns the raw sufficient statistics
``(AᵀA, AᵀY, Σx, Σy)`` of ``linalg.gram_stream_init``'s carry through
AᵀA = (Aᵀ)_bsr · A_dense and AᵀY = (Aᵀ)_bsr · Y: two kernel launches,
MACs in proportion to block density, a dense output.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ...envknobs import env_float, env_set, env_str
from ...utils.sparse import BlockSparseMatrix
from . import _build

#: Dispatch at or below this stored-block fraction when no env threshold
#: is set (the JAX package's default; its profile-store lookup is not
#: ported).
DEFAULT_DENSITY_THRESHOLD = 0.05

#: Feature-tile default, as in the JAX package. ``KEYSTONE_BLOCKSPARSE_BLOCK``
#: overrides it with the same meaning.
DEFAULT_BLOCK_SHAPE = (8, 128)

#: The CUDA kernel takes every tile side in 1..MAX_TILE.
MAX_TILE = 128


def default_block_shape(d: Optional[int] = None) -> Tuple[int, int]:
    """``KEYSTONE_BLOCKSPARSE_BLOCK`` ("8x128") or the default, shrunk to
    at most the feature width so tiny problems keep >1 block column."""
    raw = env_str("KEYSTONE_BLOCKSPARSE_BLOCK")
    if raw:
        parts = [int(p) for p in raw.lower().replace(",", "x").split("x") if p]
        bm, bn = (parts + parts)[:2]
    else:
        bm, bn = DEFAULT_BLOCK_SHAPE
    if d is not None and d > 0:
        bn = min(bn, max(8, 1 << (max(d // 4, 1).bit_length() - 1)))
    return bm, bn


def density_threshold() -> float:
    """The block-density ceiling at or below which fits take the
    block-sparse path: ``KEYSTONE_BLOCKSPARSE_THRESHOLD``, else
    :data:`DEFAULT_DENSITY_THRESHOLD`."""
    if env_set("KEYSTONE_BLOCKSPARSE_THRESHOLD"):
        return env_float("KEYSTONE_BLOCKSPARSE_THRESHOLD", DEFAULT_DENSITY_THRESHOLD)
    return DEFAULT_DENSITY_THRESHOLD


# ------------------------------------------------------------- plain version


def ell_matmul_reference(
    indices: torch.Tensor, blocks: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch padded-ELL × dense: block row i of the output is
    Σ_k blocks[i, k] @ (panel of ``b`` at block column indices[i, k]).
    A gather and a batched product per slot, summed in slot order (one
    slot's gather at a time keeps memory at one (nbr, bn, N) panel set)."""
    nbr, k_slots, bm, bn = blocks.shape
    n = b.shape[1]
    panels = b.reshape(b.shape[0] // bn, bn, n)
    idx = indices.long()
    out = torch.zeros(nbr, bm, n, dtype=torch.float32, device=b.device)
    for k in range(k_slots):
        out += torch.bmm(blocks[:, k], panels[idx[:, k]])
    return out.reshape(nbr * bm, n)


# --------------------------------------------------------------- CUDA kernel


def _kernel():
    lib = _build.load_library("ell_matmul")
    fn = lib.keystone_ell_matmul_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.keystone_ell_matmul_error.argtypes = [ctypes.c_int]
        lib.keystone_ell_matmul_error.restype = ctypes.c_char_p
    return lib


def _launch(indices: torch.Tensor, blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nbr, k_slots, bm, bn = blocks.shape
    d_pad, n = b.shape
    device = b.device
    if device.type != "cuda" or indices.device != device or blocks.device != device:
        raise ValueError(
            "ell_matmul needs indices, blocks and b on one CUDA device (or all "
            f"on the CPU); got {indices.device}, {blocks.device}, {b.device}"
        )
    if not (1 <= bm <= MAX_TILE and 1 <= bn <= MAX_TILE):
        raise ValueError(f"the CUDA ELL kernel takes tiles 1..{MAX_TILE}, got ({bm}, {bn})")
    for name, t in (("indices", indices), ("blocks", blocks), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"ell_matmul: {name} must be contiguous")
    lib = _kernel()
    out = torch.empty(nbr * bm, n, dtype=torch.float32, device=device)
    if out.numel() == 0 or k_slots == 0:
        return out.zero_()
    rc =lib.keystone_ell_matmul_f32(
        indices.data_ptr(), blocks.data_ptr(), b.data_ptr(), out.data_ptr(),
        nbr, k_slots, bm, bn, d_pad, n, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ell_matmul CUDA kernel failed: {lib.keystone_ell_matmul_error(rc).decode()}"
        )
    ell_matmul.launches += 1
    return out


def ell_matmul(
    indices: torch.Tensor, blocks: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Padded-ELL block-sparse × dense matmul → (nbr·bm, N) float32.

    ``indices`` int32 (nbr, K), ``blocks`` float32 (nbr, K, bm, bn), ``b``
    float32 (d_pad, N) with ``d_pad % bn == 0``. CUDA tensors launch the
    kernel (counted in ``ell_matmul.launches``); CPU tensors take
    :func:`ell_matmul_reference`."""
    if indices.dtype != torch.int32 or blocks.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(
            "ell_matmul takes int32 indices and float32 blocks and b; got "
            f"{indices.dtype}, {blocks.dtype}, {b.dtype}"
        )
    if indices.ndim != 2 or blocks.ndim != 4 or b.ndim != 2:
        raise ValueError("ell_matmul needs indices (nbr, K), blocks (nbr, K, bm, bn), b (d_pad, N)")
    if tuple(blocks.shape[:2]) != tuple(indices.shape):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match indices {tuple(indices.shape)}")
    bn = blocks.shape[3]
    if b.shape[0] % bn:
        raise ValueError(f"dense operand rows {b.shape[0]} not a multiple of bn={bn}")
    if indices.device.type == blocks.device.type == b.device.type == "cpu":
        return ell_matmul_reference(indices, blocks, b)
    return _launch(indices, blocks, b)


ell_matmul.launches = 0


# ------------------------------------------------------------ BSR operations


def ell_tensors(bsr: BlockSparseMatrix, device: torch.device):
    """``bsr``'s padded ELL view as (indices, blocks) tensors on ``device``."""
    idx, blocks = bsr.to_ell()
    return torch.from_numpy(idx).to(device), torch.from_numpy(blocks).to(device)


def bsr_to_dense(bsr: BlockSparseMatrix, device: torch.device) -> torch.Tensor:
    """The PADDED dense matrix of ``bsr``, built on ``device`` by
    scattering the stored blocks into zeros (duplicates add up), so the
    dense matrix never exists on the host."""
    bm, bn = bsr.block_shape
    mp, dp = bsr.padded_shape
    dense = torch.zeros(mp * dp, dtype=torch.float32, device=device)
    if bsr.nnz_blocks:
        rows = torch.from_numpy(bsr._row_of().astype(np.int64)).to(device)
        cols = torch.from_numpy(bsr.indices.astype(np.int64)).to(device)
        r = torch.arange(bm, device=device).view(1, bm, 1)
        c = torch.arange(bn, device=device).view(1, 1, bn)
        flat = (rows.view(-1, 1, 1) * bm + r) * dp + cols.view(-1, 1, 1) * bn + c
        values = torch.from_numpy(bsr.blocks).to(device)
        dense.index_put_((flat.reshape(-1),), values.reshape(-1), accumulate=True)
    return dense.view(mp, dp)


def _pad_to(x: torch.Tensor, rows: int, cols: Optional[int] = None) -> torch.Tensor:
    cols = x.shape[1] if cols is None else cols
    if tuple(x.shape) == (rows, cols):
        return x.contiguous()
    out = torch.zeros(rows, cols, dtype=x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def bsr_matmul(bsr: BlockSparseMatrix, b: torch.Tensor) -> torch.Tensor:
    """``bsr @ b`` → logical (rows, N) dense on ``b``'s device."""
    b = _pad_to(b.to(torch.float32), bsr.padded_shape[1])
    idx, blocks = ell_tensors(bsr, b.device)
    return ell_matmul(idx, blocks, b)[: bsr.shape[0]]


def bsr_gram_totals(
    bsr: BlockSparseMatrix,
    y: torch.Tensor,
    *,
    a_dense: Optional[torch.Tensor] = None,
):
    """Raw sufficient statistics ``(AᵀA, AᵀY, Σx, Σy)`` of the logical
    (rows, d) matrix on ``y``'s device — the tuple
    ``linalg.gram_stream_init`` seeds, finished by
    ``linalg.gram_stream_finish``. ``y`` is the (rows, k) target matrix.
    Pass ``a_dense`` when the caller already holds the dense matrix;
    otherwise it is scattered from the blocks on the device."""
    device = y.device
    d = bsr.shape[1]
    mp, dp = bsr.padded_shape
    y = _pad_to(y.to(torch.float32), mp)  # pad rows are zero: contribute nothing
    if a_dense is None:
        a = bsr_to_dense(bsr, device)
    else:
        a = _pad_to(torch.as_tensor(a_dense, dtype=torch.float32).to(device), mp, dp)
    idx_t, blocks_t = ell_tensors(bsr.transpose(), device)
    g = ell_matmul(idx_t, blocks_t, a)
    c = ell_matmul(idx_t, blocks_t, y)
    sa = a.sum(dim=0)
    sb = y.sum(dim=0)
    return g[:d, :d], c[:d], sa[:d], sb


__all__ = [
    "DEFAULT_BLOCK_SHAPE",
    "DEFAULT_DENSITY_THRESHOLD",
    "BlockSparseMatrix",
    "bsr_gram_totals",
    "bsr_matmul",
    "bsr_to_dense",
    "default_block_shape",
    "density_threshold",
    "ell_matmul",
    "ell_matmul_reference",
]
