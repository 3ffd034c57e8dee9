"""Block-sparse (BSR) matmul and Gram accumulation.

Port of ``keystone_tpu/ops/pallas/blocksparse.py``. The host-side
:class:`~keystone_tpu_torch.utils.sparse.BlockSparseMatrix` is flattened to
a padded ELL view — ``K`` block slots per block row, the stored blocks in
the leading ``counts[i]`` slots, unused slots holding a zero block at
column 0 — and multiplied into a dense operand by :func:`ell_matmul`,
which reads the stored slots only:

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

#: Dispatch at or below this stored-block fraction when neither the env
#: nor the profile store sets a threshold (the JAX package's default).
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


def density_threshold(rows: Optional[str] = None) -> float:
    """The block-density ceiling at or below which fits take the
    block-sparse path. Resolution order, as in the JAX package: explicit
    ``KEYSTONE_BLOCKSPARSE_THRESHOLD`` → the highest-speedup
    ``blocksparse:threshold`` entry of the profile store for the rows
    bucket ``rows`` (``obs.store.rows_bucket``; None reads every bucket)
    → :data:`DEFAULT_DENSITY_THRESHOLD`. Only entries whose environment
    fingerprint names this torch and this card are read."""
    if env_set("KEYSTONE_BLOCKSPARSE_THRESHOLD"):
        return env_float("KEYSTONE_BLOCKSPARSE_THRESHOLD", DEFAULT_DENSITY_THRESHOLD)
    try:
        from ...obs import store as _store

        store = _store.get_store()
        if store is not None:
            best, best_speedup = None, None
            for _key, _shape, m in sorted(
                store.entries(key_prefix="blocksparse:threshold", rows=rows)
            ):
                if "threshold" not in m:
                    continue
                speedup = float(m.get("speedup", 0.0))
                if best_speedup is None or speedup > best_speedup:
                    best, best_speedup = float(m["threshold"]), speedup
            if best is not None:
                return best
    except Exception:  # a broken store must never block a fit
        pass
    return DEFAULT_DENSITY_THRESHOLD


# ------------------------------------------------------------- plain version


def ell_matmul_reference(
    indices: torch.Tensor,
    blocks: torch.Tensor,
    b: torch.Tensor,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch padded-ELL × dense: block row i of the output is
    Σ_{k < counts[i]} blocks[i, k] @ (panel of ``b`` at block column
    indices[i, k]); every slot when ``counts`` is None. A gather and a
    batched product per slot, summed in slot order (one slot's gather at a
    time keeps memory at one (nbr, bn, N) panel set); with ``counts``, only
    the rows whose slot k is stored take part in it."""
    nbr, k_slots, bm, bn = blocks.shape
    n = b.shape[1]
    panels = b.reshape(b.shape[0] // bn, bn, n)
    idx = indices.long()
    out = torch.zeros(nbr, bm, n, dtype=torch.float32, device=b.device)
    for k in range(k_slots):
        if counts is None:
            out += torch.bmm(blocks[:, k], panels[idx[:, k]])
            continue
        rows = torch.nonzero(counts > k).flatten()
        if rows.numel():
            out[rows] += torch.bmm(blocks[rows, k], panels[idx[rows, k]])
    return out.reshape(nbr * bm, n)


# --------------------------------------------------------------- CUDA kernel


def _kernel():
    lib = _build.load_library("ell_matmul")
    fn = lib.keystone_ell_matmul_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.keystone_ell_matmul_error.argtypes = [ctypes.c_int]
        lib.keystone_ell_matmul_error.restype = ctypes.c_char_p
    return lib


def _launch(
    indices: torch.Tensor,
    blocks: torch.Tensor,
    b: torch.Tensor,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel on checked arguments (see :func:`ell_matmul`)."""
    nbr, k_slots, bm, bn = blocks.shape
    d_pad, n = b.shape
    device = b.device
    on_device = [indices.device, blocks.device] + ([] if counts is None else [counts.device])
    if device.type != "cuda" or any(d != device for d in on_device):
        raise ValueError(
            "ell_matmul needs indices, blocks, b (and counts) on one CUDA device "
            f"(or all on the CPU); got {indices.device}, {blocks.device}, {b.device}"
            + ("" if counts is None else f", {counts.device}")
        )
    if not (1 <= bm <= MAX_TILE and 1 <= bn <= MAX_TILE):
        raise ValueError(f"the CUDA ELL kernel takes tiles 1..{MAX_TILE}, got ({bm}, {bn})")
    for name, t in (("indices", indices), ("blocks", blocks), ("b", b), ("counts", counts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ell_matmul: {name} must be contiguous")
    lib = _kernel()
    out = torch.empty(nbr * bm, n, dtype=torch.float32, device=device)
    if out.numel() == 0 or k_slots == 0:
        return out.zero_()
    rc = lib.keystone_ell_matmul_f32(
        indices.data_ptr(), None if counts is None else counts.data_ptr(),
        blocks.data_ptr(), b.data_ptr(), out.data_ptr(),
        nbr, k_slots, bm, bn, d_pad, n, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        _build.raise_status(
            "ell_matmul CUDA kernel", lib.keystone_ell_matmul_error(rc).decode(),
            rc == _build.CUDA_ERROR_MEMORY_ALLOCATION,
        )
    ell_matmul.launches += 1
    return out


def _check_args(indices, blocks, b, counts) -> None:
    """Dtypes and shapes of :func:`ell_matmul`'s arguments; reads nothing
    back from the card."""
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
    if counts is not None:
        if counts.dtype != torch.int32:
            raise TypeError(f"ell_matmul takes int32 counts; got {counts.dtype}")
        if tuple(counts.shape) != (indices.shape[0],):
            raise ValueError(
                f"counts {tuple(counts.shape)} do not match {indices.shape[0]} block rows"
            )


def _dispatch(indices, blocks, b, counts):
    if all(t.device.type == "cpu" for t in (indices, blocks, b, counts) if t is not None):
        return ell_matmul_reference(indices, blocks, b, counts)
    return _launch(indices, blocks, b, counts)


def _ell_matmul_host_counts(indices, blocks, b, counts):
    """:func:`ell_matmul` for ``counts`` from :func:`ell_tensors`, which
    lie in 0..K by construction: their range is not read back from the
    card, so the main path's launches queue without a host sync."""
    _check_args(indices, blocks, b, counts)
    return _dispatch(indices, blocks, b, counts)


def ell_matmul(
    indices: torch.Tensor,
    blocks: torch.Tensor,
    b: torch.Tensor,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Padded-ELL block-sparse × dense matmul → (nbr·bm, N) float32.

    ``indices`` int32 (nbr, K), ``blocks`` float32 (nbr, K, bm, bn), ``b``
    float32 (d_pad, N) with ``d_pad % bn == 0``. ``counts``, int32 (nbr,)
    with 0 ≤ counts ≤ K, says how many leading slots of each block row
    are stored: slot k of row i takes part only where k < counts[i], and
    the other slots are never read. None means every slot, as in the TPU
    kernel. The two agree whenever the padded slots hold zero blocks at
    column 0, except where panel 0 of ``b`` holds a non-finite value: a
    padded slot then adds 0·inf or 0·NaN = NaN without counts and nothing
    with them. CUDA tensors launch the kernel (counted in
    ``ell_matmul.launches``); CPU tensors take
    :func:`ell_matmul_reference`. Checking the range of ``counts`` on the
    card reads it back to the host (a sync); :func:`bsr_matmul` and
    :func:`bsr_gram_totals` build theirs valid and skip that."""
    _check_args(indices, blocks, b, counts)
    if counts is not None and counts.numel():
        lo, hi = (int(v) for v in torch.aminmax(counts))
        if lo < 0 or hi > indices.shape[1]:
            raise ValueError(f"counts must lie in 0..{indices.shape[1]} (K); got {lo}..{hi}")
    return _dispatch(indices, blocks, b, counts)


ell_matmul.launches = 0


# ------------------------------------------------------------ BSR operations


def ell_tensors(bsr: BlockSparseMatrix, device: torch.device):
    """``bsr``'s padded ELL view as (indices, blocks, counts) tensors on
    ``device``. ``to_ell`` puts the stored blocks of a row in its leading
    slots, so counts = np.diff(indptr), the stored blocks per block row.
    They lie in 0..K by construction: ``to_ell`` refuses a decreasing
    ``indptr`` and sizes K to the largest count."""
    idx, blocks = bsr.to_ell()
    counts = np.diff(bsr.indptr).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (idx, blocks, counts))


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
    idx, blocks, counts = ell_tensors(bsr, b.device)
    return _ell_matmul_host_counts(idx, blocks, b, counts)[: bsr.shape[0]]


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
    idx_t, blocks_t, counts_t = ell_tensors(bsr.transpose(), device)
    g = _ell_matmul_host_counts(idx_t, blocks_t, a, counts_t)
    c = _ell_matmul_host_counts(idx_t, blocks_t, y, counts_t)
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
    "ell_tensors",
]
