"""Streaming row-space sketch operators: CountSketch and SRHT.

Port of ``keystone_tpu/sketch/core.py``. Both sketches compress the
n-row (features, labels) stream into an O(s·d) carry while staying exact
under every composition the streaming engine performs — chunking, merge,
exponential decay and resume. Every row's sketch contribution is a
deterministic function of its ABSOLUTE dataset row index (threaded
through the engine's pad mask, which stores ``row_index + 1`` per row;
see ``workflow/streaming.py``), so the sketch of a set of rows is the
sum of per-row contributions however the rows were batched.

- **CountSketch** hashes row i to bucket h(i) ∈ [s] with sign σ(i) and
  scatter-adds σ(i)·xᵢ (``index_add_`` along rows) — O(n·d) stream work.
- **SRHT** uses the closed-form Walsh–Hadamard entry
  H(r, i) = (−1)^popcount(r & i), sampled at s seeded rows r and
  sign-flipped per input row: each chunk contributes an (s, c) sign
  matrix times the chunk — O(s·c·d) work.

The carry is ``(SA, SY, s1, Σx, Σy)``: sketched features (s, d),
sketched labels (s, k), the sketch of the all-ones vector (s,), and the
raw column sums. ``s1`` makes centring algebraic at finish time:
S·(A − 1μᵀ) = SA − s1·μᵀ.

The row hash matches the JAX package's ``uint32`` murmur3 finalizer bit
for bit. Torch's ``uint32`` supports few operations, so the lanes are
``int64`` holding values below 2³², masked after each step; each 32-bit
multiplier is applied as two 16-bit halves so no intermediate reaches
2⁶³ (nothing relies on signed overflow). SRHT needs only the parity of
``popcount(r & i)``, folded by shifts and xors.

Row indices ride the float32 mask exactly up to 2²⁴ rows
(:data:`MASK_INDEX_EXACT_ROWS`); the solvers refuse longer streams.

The carry leaves are updated in place, as ``linalg.gram_stream_step``
updates the Gram carry. Every product runs at IEEE fp32 through the
solver binding on a card (``ops/cuda/gemm.py``), the precision the JAX
package's plain ``@`` has on the CPU.

Each step carries the blocked-carry protocol of the 2-D streamed fits
(``model_layout`` / ``model_block_step``, ``workflow/streaming.py``): a
carry block holds one column block of SA and Σx; SY, s1 and Σy are
feature-free and accumulate on block 0 only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..parallel import linalg

#: Largest row count whose absolute indices are exactly representable in
#: the engine's float32 mask lane (2^24). Beyond this, index encoding
#: would silently collide — solvers raise instead of degrading.
MASK_INDEX_EXACT_ROWS = 1 << 24

#: Registered sketch variants (KEYSTONE_SKETCH_VARIANT values).
VARIANTS = ("countsketch", "srht")

_U32 = 0xFFFFFFFF


def sketch_state_bytes(s: int, d: int, k: int) -> int:
    """Bytes one float32 sketch carry holds: the O(s·d) state."""
    return 4 * (s * d + s * k + s + d + k)


# ------------------------------------------------------------- row hashing


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h · c) mod 2³²`` for int64 lanes holding uint32 values: the
    multiplier split into 16-bit halves keeps every product below 2⁴⁸."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((h * hi) & 0xFFFF) << 16) + h * lo) & _U32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 lanes."""
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _row_hash(idx: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """Deterministic uint32 hash (in int64 lanes) of absolute row indices
    under (seed, salt) — the per-row randomness both variants draw from."""
    mix = (int(seed) * 0x9E3779B9 + int(salt) * 0x7F4A7C15) & _U32
    return _avalanche(idx.to(torch.int64) ^ mix)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """popcount(x) & 1 for values below 2³²."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def srht_sample_rows(s: int, seed: int) -> np.ndarray:
    """The s sampled Walsh–Hadamard row indices, host-generated and
    regenerable from (s, seed) alone — never persisted; resume rebuilds
    them from the envelope's meta."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x5E1EC7ED))
    return rng.integers(0, 1 << 32, size=int(s), dtype=np.uint64).astype(np.uint32)


def _mask_rows(mask: torch.Tensor):
    """(absolute row indices as int64, float32 validity) of a chunk's
    mask lane, which holds index + 1 (0 for pad rows)."""
    idx1 = mask[:, 0].to(torch.int64)
    valid = (idx1 > 0).to(torch.float32)
    return torch.clamp_min(idx1 - 1, 0), valid


def _signs(idx: torch.Tensor, valid: torch.Tensor, seed: int) -> torch.Tensor:
    return (1.0 - 2.0 * (_row_hash(idx, seed, 1) & 1).to(torch.float32)) * valid


def countsketch_hash(mask: torch.Tensor, s: int, seed: int):
    """(bucket int64, sign float32) per row of a chunk's mask lane:
    bucket h(i) ∈ [s] and σ(i) ∈ {±1}, 0 for pad rows."""
    idx, valid = _mask_rows(mask)
    bucket = _row_hash(idx, seed, 0) % int(s)
    return bucket, _signs(idx, valid, seed)


def srht_mix_matrix(mask: torch.Tensor, s: int, seed: int) -> torch.Tensor:
    """The (s, rows) SRHT block of a chunk: H(r, i)·σ(i)/√s with
    H(r, i) = (−1)^popcount(r & i) — row-independent, so chunking and
    merging stay exact."""
    idx, valid = _mask_rows(mask)
    rows = torch.from_numpy(srht_sample_rows(s, seed).astype(np.int64)).to(mask.device)
    parity = _parity(rows[:, None] & idx[None, :]).to(torch.float32)
    return (1.0 - 2.0 * parity) * _signs(idx, valid, seed)[None, :] * (1.0 / math.sqrt(s))


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE fp32 product: the binding on a card, ``torch.matmul`` on the CPU."""
    return linalg._mm(a, b, "ieee_fp32")


def sketch_gram(sa: torch.Tensor) -> torch.Tensor:
    """K = SA·SAᵀ at IEEE fp32, the feature axis contracted in 4,096-column
    partial sums (``linalg._mm_nt``): over a TIMIT-wide sketch one long
    fp32 product lands two orders further from float64 (PERF.md,
    ``timit_sketched``)."""
    return linalg._mm_nt(sa, sa, "ieee_fp32")


# ---------------------------------------------------------------- the carry


def sketch_stream_init(s: int, d: int, k: int, device: torch.device):
    """Fresh float32 carry: (SA (s,d), SY (s,k), s1 (s,), Σx (d,),
    Σy (k,)) — every leaf additive over chunks."""
    return (
        torch.zeros(s, d, dtype=torch.float32, device=device),
        torch.zeros(s, k, dtype=torch.float32, device=device),
        torch.zeros(s, dtype=torch.float32, device=device),
        torch.zeros(d, dtype=torch.float32, device=device),
        torch.zeros(k, dtype=torch.float32, device=device),
    )


@functools.lru_cache(maxsize=32)
def sketch_stream_step(variant: str, seed: int):
    """The fold step for (variant, seed), memoized so repeated fits reuse
    ONE function object and therefore one record in the engine's step
    cache (no new chunk signature on a refit).

    The returned function carries ``needs_mask = True``: the engine then
    passes the chunk's pad mask, whose lane holds each row's absolute
    dataset index + 1 (0 for pads). It updates the carry in place and
    returns it.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown sketch variant {variant!r} (known: {VARIANTS})")
    seed = int(seed)

    if variant == "countsketch":

        def step(carry, x, y, mask):
            sa, sy, s1, sx, sums_y = carry
            x = x.to(sa.dtype)
            y = y.to(sa.dtype)
            bucket, sign = countsketch_hash(mask, sa.shape[0], seed)
            sa.index_add_(0, bucket, sign[:, None] * x)
            sy.index_add_(0, bucket, sign[:, None] * y)
            s1.index_add_(0, bucket, sign)
            # Pads are exact zeros in x (the chain re-zeroes them) and y
            # (host pad), so raw column sums need no masking.
            sx.add_(x.sum(dim=0))
            sums_y.add_(y.sum(dim=0))
            return carry

        def block_step(carry, x, y, mask, block_index):
            # This block holds the block_index-th column block of SA and
            # Σx and scatter-adds its own column slice of the chunk.
            sa, sy, s1, sx, sums_y = carry
            b = sa.shape[1]
            xb = x[:, block_index * b : (block_index + 1) * b].to(sa.dtype)
            bucket, sign = countsketch_hash(mask, sa.shape[0], seed)
            sa.index_add_(0, bucket, sign[:, None] * xb)
            sx.add_(xb.sum(dim=0))
            if block_index == 0:
                y = y.to(sa.dtype)
                sy.index_add_(0, bucket, sign[:, None] * y)
                s1.index_add_(0, bucket, sign)
                sums_y.add_(y.sum(dim=0))
            return carry

    else:  # srht

        def step(carry, x, y, mask):
            sa, sy, s1, sx, sums_y = carry
            x = x.to(sa.dtype)
            y = y.to(sa.dtype)
            m = srht_mix_matrix(mask, sa.shape[0], seed)
            sa.add_(_mm32(m, x))
            sy.add_(_mm32(m, y))
            s1.add_(m.sum(dim=1))
            sx.add_(x.sum(dim=0))
            sums_y.add_(y.sum(dim=0))
            return carry

        def block_step(carry, x, y, mask, block_index):
            sa, sy, s1, sx, sums_y = carry
            b = sa.shape[1]
            xb = x[:, block_index * b : (block_index + 1) * b].to(sa.dtype)
            m = srht_mix_matrix(mask, sa.shape[0], seed)
            sa.add_(_mm32(m, xb))
            sx.add_(xb.sum(dim=0))
            if block_index == 0:
                y = y.to(sa.dtype)
                sy.add_(_mm32(m, y))
                s1.add_(m.sum(dim=1))
                sums_y.add_(y.sum(dim=0))
            return carry

    step.needs_mask = True
    step.sketch_variant = variant
    step.sketch_seed = seed
    # Blocked-carry protocol: the feature axis of each carry leaf (SA's
    # columns, Σx) — None = feature-free.
    step.model_layout = (1, None, None, 0, None)
    step.model_block_step = block_step
    return step


def sketch_stream_finish(carry, n: int):
    """Centred sketches from the accumulated carry: S·Ac, S·Yc, and the
    means — S·(A − 1μᵀ) = SA − s1·μᵀ, exact for any sketch that is a
    linear map of the rows (both variants are)."""
    sa, sy, s1, sx, sums_y = carry
    mu_a = sx / n
    mu_b = sums_y / n
    sa_c = sa - s1[:, None] * mu_a[None, :]
    sy_c = sy - s1[:, None] * mu_b[None, :]
    return sa_c, sy_c, mu_a, mu_b


def index_mask(start: int, stop: int, device: torch.device) -> torch.Tensor:
    """The mask lane of rows [start, stop): absolute index + 1 per row."""
    return torch.arange(start + 1, stop + 1, dtype=torch.float32, device=device)[:, None]


# ----------------------------------------------------------- in-core sketch


def sketch_rows(x: torch.Tensor, start_index: int, variant: str, seed: int, s: int):
    """Sketch a materialized row block whose rows occupy absolute indices
    [start_index, start_index + rows): the in-core counterpart of one
    stream chunk, sharing the exact per-row hashing. Returns (SA, s1)."""
    x = x.to(torch.float32)
    rows, d = x.shape
    carry = sketch_stream_init(s, d, 1, x.device)
    y = torch.zeros(rows, 1, dtype=torch.float32, device=x.device)
    sa, _, s1, _, _ = sketch_stream_step(variant, seed)(
        carry, x, y, index_mask(start_index, start_index + rows, x.device)
    )
    return sa, s1


__all__ = [
    "MASK_INDEX_EXACT_ROWS",
    "VARIANTS",
    "countsketch_hash",
    "index_mask",
    "sketch_gram",
    "sketch_rows",
    "sketch_state_bytes",
    "sketch_stream_finish",
    "sketch_stream_init",
    "sketch_stream_step",
    "srht_mix_matrix",
    "srht_sample_rows",
]
