"""Host-side sparse helpers and the BSR block container.

A numpy copy of ``keystone_tpu/utils/sparse.py``: ``csr_row`` is the row
format the text featurizers emit, and :class:`BlockSparseMatrix` is the
bridge from those rows to the CUDA block-sparse kernel
(``ops/cuda/blocksparse.py``), tracking nonzero structure at tile
granularity. numpy at import; scipy only inside the CSR helpers.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np


def csr_row(values: Mapping[int, float], num_features: int):
    """Build a (1, num_features) scipy CSR row from a {column: value} map."""
    import scipy.sparse as sp

    if not values:
        return sp.csr_matrix((1, num_features))
    cols = np.fromiter(values.keys(), dtype=np.int64)
    vals = np.fromiter(values.values(), dtype=np.float64)
    # Built as CSR directly, columns sorted: the same arrays as the JAX
    # package's COO → CSR conversion (keys are unique), at half its cost.
    order = np.argsort(cols, kind="stable")
    return sp.csr_matrix((vals[order], cols[order], np.array([0, len(cols)])), shape=(1, num_features))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BlockSparseMatrix:
    """A host-side BSR matrix: only blocks with any nonzero are stored.

    - ``shape`` — the LOGICAL (rows, cols); padded rows/cols are zeros.
    - ``block_shape`` — (bm, bn) tile size.
    - ``indptr`` — (n_block_rows + 1,) block-row pointers into indices.
    - ``indices`` — (nnzb,) block-column index per stored block.
    - ``blocks`` — (nnzb, bm, bn) float32 block payloads; duplicate
      (i, j) blocks add up.
    """

    def __init__(
        self,
        shape: Tuple[int, int],
        block_shape: Tuple[int, int],
        indptr: np.ndarray,
        indices: np.ndarray,
        blocks: np.ndarray,
    ):
        self.shape = (int(shape[0]), int(shape[1]))
        self.block_shape = (int(block_shape[0]), int(block_shape[1]))
        self.indptr = np.asarray(indptr, dtype=np.int32)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.blocks = np.asarray(blocks, dtype=np.float32)

    # ------------------------------------------------------------ properties
    @property
    def n_block_rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_block_cols(self) -> int:
        return _round_up(self.shape[1], self.block_shape[1]) // self.block_shape[1]

    @property
    def nnz_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bm, bn = self.block_shape
        return (self.n_block_rows * bm, self.n_block_cols * bn)

    def density(self) -> float:
        """Stored fraction of the block grid — what the dispatch
        threshold compares against."""
        total = self.n_block_rows * self.n_block_cols
        return self.nnz_blocks / total if total else 1.0

    def blocks_skipped(self) -> int:
        """Zero blocks the kernel never touches."""
        return self.n_block_rows * self.n_block_cols - self.nnz_blocks

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_dense(
        cls,
        a: np.ndarray,
        block_shape: Tuple[int, int] = (8, 128),
        tol: float = 0.0,
    ) -> "BlockSparseMatrix":
        """Tile a dense (m, d) array; keep blocks with any |entry| > tol."""
        a = np.asarray(a, dtype=np.float32)
        if a.ndim != 2:
            raise ValueError(f"need a 2-D matrix, got shape {a.shape}")
        m, d = a.shape
        bm, bn = int(block_shape[0]), int(block_shape[1])
        mp, dp = _round_up(max(m, 1), bm), _round_up(max(d, 1), bn)
        if (mp, dp) != (m, d):
            padded = np.zeros((mp, dp), dtype=np.float32)
            padded[:m, :d] = a
            a = padded
        nbr, nbc = mp // bm, dp // bn
        tiles = a.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        keep = np.abs(tiles).max(axis=(2, 3)) > tol  # (nbr, nbc)
        counts = keep.sum(axis=1)
        indptr = np.zeros(nbr + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        rows, cols = np.nonzero(keep)
        return cls((m, d), (bm, bn), indptr, cols, tiles[rows, cols])

    @classmethod
    def from_csr_rows(
        cls,
        rows: Sequence[Any],
        block_shape: Tuple[int, int] = (8, 128),
    ) -> "BlockSparseMatrix":
        """Stack (1, d) scipy CSR rows into BSR without ever
        materializing the dense matrix."""
        import scipy.sparse as sp

        stacked = sp.vstack([r.tocsr() for r in rows], format="csr")
        m, d = stacked.shape
        bm, bn = int(block_shape[0]), int(block_shape[1])
        mp, dp = _round_up(max(m, 1), bm), _round_up(max(d, 1), bn)
        if (mp, dp) != (m, d):  # scipy BSR needs whole blocks
            stacked = sp.csr_matrix(
                (stacked.data, stacked.indices, stacked.indptr), shape=(m, dp)
            )
            stacked = sp.vstack(
                [stacked, sp.csr_matrix((mp - m, dp))], format="csr"
            )
        bsr = stacked.tobsr(blocksize=(bm, bn))
        bsr.sort_indices()
        return cls((m, d), (bm, bn), bsr.indptr, bsr.indices, bsr.data)

    def _row_of(self) -> np.ndarray:
        """Block-row index of every stored block (CSR expansion)."""
        return np.repeat(
            np.arange(self.n_block_rows, dtype=np.int32),
            np.diff(self.indptr),
        )

    # ------------------------------------------------------------ conversions
    def to_dense(self) -> np.ndarray:
        """The logical (rows, cols) dense array (padding cropped)."""
        bm, bn = self.block_shape
        nbr, nbc = self.n_block_rows, self.n_block_cols
        out = np.zeros((nbr, nbc, bm, bn), dtype=np.float32)
        # add (not assign): duplicate (i, j) blocks accumulate, matching
        # the kernel's sum semantics.
        np.add.at(out, (self._row_of(), self.indices), self.blocks)
        out = out.transpose(0, 2, 1, 3).reshape(nbr * bm, nbc * bn)
        return out[: self.shape[0], : self.shape[1]]

    def to_ell(self, max_blocks_per_row: Optional[int] = None):
        """Padded ELL view for the device kernel: fixed ``K`` slots per
        block row, zero blocks at column 0 in unused slots (inert under
        accumulation). Returns ``(indices (nbr, K) int32, blocks
        (nbr, K, bm, bn) float32)``."""
        bm, bn = self.block_shape
        nbr = self.n_block_rows
        counts = np.diff(self.indptr)
        k = int(counts.max()) if len(counts) else 0
        k = max(1, k if max_blocks_per_row is None else max(k, max_blocks_per_row))
        idx = np.zeros((nbr, k), dtype=np.int32)
        blocks = np.zeros((nbr, k, bm, bn), dtype=np.float32)
        slot = np.arange(len(self.indices)) - np.repeat(
            self.indptr[:-1], counts
        )
        rows = self._row_of()
        idx[rows, slot] = self.indices
        blocks[rows, slot] = self.blocks
        return idx, blocks

    def transpose(self) -> "BlockSparseMatrix":
        """BSR of the PADDED transpose: block (i, j) → block (j, i) with
        each payload transposed; the logical transpose shape is recorded."""
        nbr_t = self.n_block_cols
        order = np.argsort(self.indices, kind="stable")
        new_cols = self._row_of()[order]
        counts = np.bincount(self.indices, minlength=nbr_t)
        indptr = np.zeros(nbr_t + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        blocks = self.blocks[order].transpose(0, 2, 1)
        return BlockSparseMatrix(
            (self.shape[1], self.shape[0]),
            (self.block_shape[1], self.block_shape[0]),
            indptr,
            new_cols,
            np.ascontiguousarray(blocks),
        )


def block_density(a: np.ndarray, block_shape: Tuple[int, int], tol: float = 0.0) -> float:
    """Stored-block fraction of a dense matrix at tile granularity —
    the cheap dispatch probe. Pure reductions over a reshaped view (max
    and −min instead of an |a| copy); only a non-block-aligned shape
    pays one padded copy. No block gather, no BSR materialization."""
    a = np.asarray(a)
    m, d = a.shape
    bm, bn = int(block_shape[0]), int(block_shape[1])
    mp, dp = _round_up(max(m, 1), bm), _round_up(max(d, 1), bn)
    if (mp, dp) != (m, d):
        padded = np.zeros((mp, dp), dtype=a.dtype)
        padded[:m, :d] = a
        a = padded
    tiles = a.reshape(mp // bm, bm, dp // bn, bn)
    peak = np.maximum(tiles.max(axis=(1, 3)), -tiles.min(axis=(1, 3)))
    keep = peak > tol
    return float(keep.mean()) if keep.size else 1.0


def block_density_exceeds(
    a: np.ndarray,
    block_shape: Tuple[int, int],
    threshold: float,
    tol: float = 0.0,
    band_rows: int = 64,
) -> bool:
    """True when the matrix's block density exceeds ``threshold``. Scans
    block-row bands and returns as soon as the answer is settled, so a
    fully dense matrix exits after the first band."""
    a = np.asarray(a)
    m, d = a.shape
    bm, bn = int(block_shape[0]), int(block_shape[1])
    mp, dp = _round_up(max(m, 1), bm), _round_up(max(d, 1), bn)
    nbr, nbc = mp // bm, dp // bn
    total = nbr * nbc
    budget = threshold * total
    kept = 0
    scanned = 0
    for start in range(0, nbr, band_rows):
        stop = min(start + band_rows, nbr)
        lo, hi = start * bm, min(stop * bm, m)
        band = a[lo:hi]
        if band.shape != ((stop - start) * bm, dp):
            padded = np.zeros(((stop - start) * bm, dp), dtype=a.dtype)
            padded[: band.shape[0], : band.shape[1]] = band
            band = padded
        tiles = band.reshape(stop - start, bm, nbc, bn)
        peak = np.maximum(tiles.max(axis=(1, 3)), -tiles.min(axis=(1, 3)))
        kept += int((peak > tol).sum())
        scanned += (stop - start) * nbc
        if kept > budget:
            return True
        if kept + (total - scanned) <= budget:
            return False
    return kept > budget


def is_sparse_rows(items: Sequence[Any]) -> bool:
    """True when ``items`` look like scipy sparse (1, d) rows."""
    if not len(items):
        return False
    first = items[0]
    return hasattr(first, "tocsr") and hasattr(first, "shape")
