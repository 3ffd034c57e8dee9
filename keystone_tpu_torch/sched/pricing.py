"""Lease pricing and chunk policy: the cost observatory made executable.

Port of ``keystone_tpu/sched/pricing.py`` for one card.

The scheduler never admits unpriced work. Every lease request carries its
fold geometry (rows x width x classes) and is priced *before* admission
down a provenance ladder:

1. **store/tune** — a valid (non-stale) ProfileStore ``stream:<chain>:``
   entry measured on this backend: predicted wall = rows / measured
   rows_per_s. ``source`` records whether the entry was searched by
   ``tune`` (``tune``) or merely observed (``store``).
2. **roofline** — no measurement: first-principles floor from the
   probe-calibrated :class:`~keystone_tpu_torch.obs.cost.Roofline` over the
   Gram fold's flop/byte facts (``source="roofline"``).
3. **default** — no roofline either (cost observatory off): a flat
   rows/s guess (``KEYSTONE_SCHED_DEFAULT_ROWS_PER_S``).

The same ladder chooses chunk geometry for *scheduled* folds
(:func:`choose_chunk_rows`): a tuned/measured entry wins outright;
otherwise the roofline placement decides — memory-bound folds take
larger chunks (amortize the host->device transfer) up to the KV304-style
per-device residency budget (a quarter of the card's memory, read with
``torch.cuda.mem_get_info`` on the explicit device), replacing the static
4096 default on the scheduled path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..envknobs import env_float, env_int


def gram_stream_facts(
    rows: int, width: int, classes: int
) -> Tuple[float, float]:
    """(flops, bytes) for a Gram-statistics fold over ``rows`` examples:
    X'X (2*w*w per row) + X'Y (2*w*k per row) flops; bytes = the
    streamed operands (x and y rows at f32) plus one carry round-trip.
    Deliberately first-order — the roofline only needs the right decade.
    """
    w, k = max(int(width), 1), max(int(classes), 1)
    n = max(int(rows), 0)
    flops = float(n) * (2.0 * w * w + 2.0 * w * k)
    bytes_accessed = 4.0 * n * (w + k) + 8.0 * (w * w + w * k)
    return flops, bytes_accessed


@dataclass(frozen=True)
class LeasePrice:
    """A lease's predicted cost with its provenance — what admission
    compares against the idle-gap budget and what the ledger joins the
    measured wall to."""

    seconds: Optional[float]
    source: str  # tune | store | roofline | default
    rows_per_s: Optional[float] = None
    roofline: Optional[str] = None  # compute-bound | memory-bound | None
    intensity: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"source": self.source}
        for field in ("seconds", "rows_per_s", "roofline", "intensity"):
            v = getattr(self, field)
            if v is not None:
                out[field] = round(v, 6) if isinstance(v, float) else v
        return out


def _store_rate(
    store: Any, chain: str
) -> Optional[Tuple[float, str, Optional[int], Optional[int]]]:
    """Best measured rows/s under ``stream:<chain>:`` among valid
    entries: (rows_per_s, source, chunk_rows, prefetch_depth). Stale
    (drift-marked) and fingerprint-invalid entries never price a lease —
    the drift sentinel's whole point."""
    if store is None:
        return None
    best = None
    try:
        rows_iter = sorted(store.entries(key_prefix=f"stream:{chain}:"))
    except Exception:
        return None
    for key, _shape, m in rows_iter:
        rate = m.get("rows_per_s")
        if not rate:
            continue
        rate = float(rate)
        if best is None or rate > best[0]:
            source = "tune" if m.get("source") == "tune" else "store"
            chunk = m.get("chunk_rows")
            best = (
                rate,
                source,
                int(chunk) if chunk else None,
                int(m["prefetch_depth"]) if m.get("prefetch_depth") else None,
            )
    return best


def price_stream_fold(
    rows: int,
    width: int,
    classes: int,
    chain: str = "()",
    store: Any = None,
    device: Any = None,
) -> LeasePrice:
    """Price one streamed Gram fold down the provenance ladder
    (``device`` picks the roofline's card; None: this process's)."""
    flops, bytes_accessed = gram_stream_facts(rows, width, classes)
    intensity = flops / bytes_accessed if bytes_accessed else None

    roof = None
    placement = None
    try:
        from ..obs import cost as _cost

        roof = _cost.get_roofline(device=device)
    except Exception:
        roof = None
    if roof is not None:
        placement = roof.classify(intensity)

    measured = _store_rate(store, chain)
    if measured is not None:
        rate, source, _chunk, _prefetch = measured
        return LeasePrice(
            seconds=rows / rate if rate > 0 else None,
            source=source,
            rows_per_s=rate,
            roofline=placement,
            intensity=intensity,
        )
    if roof is not None:
        seconds = roof.predicted_seconds(flops, bytes_accessed)
        if seconds is not None:
            return LeasePrice(
                seconds=seconds,
                source="roofline",
                rows_per_s=rows / seconds if seconds > 0 else None,
                roofline=placement,
                intensity=intensity,
            )
    rate = env_float("KEYSTONE_SCHED_DEFAULT_ROWS_PER_S", 200_000.0)
    return LeasePrice(
        seconds=rows / rate if rate > 0 else None,
        source="default",
        rows_per_s=rate,
        roofline=placement,
        intensity=intensity,
    )


# ------------------------------------------------------------ chunk policy


def _residency_budget_bytes(device: Any = None) -> int:
    """Bytes a scheduled fold may hold resident for staged chunks — the
    KV304 discipline applied prospectively: a quarter of the card's
    memory (``torch.cuda.mem_get_info`` on the explicit CUDA ``device``).
    The host has no such limit, so the env knob's default (256 MiB)
    stands in there."""
    explicit = env_int("KEYSTONE_SCHED_RESIDENCY_BYTES", 0)
    if explicit > 0:
        return explicit
    if device is not None:
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            _free, total = torch.cuda.mem_get_info(dev)
            # Same fraction KV304 allows a fit's working set.
            return int(total) // 4
    return 256 * 1024 * 1024


def choose_chunk_rows(
    rows: int,
    width: int,
    classes: int,
    chain: str = "()",
    store: Any = None,
    default: Optional[int] = None,
    device: Any = None,
) -> Tuple[int, int, str]:
    """(chunk_rows, prefetch_depth, source) for a *scheduled* fold.

    A tuned/measured ProfileStore entry wins outright (``source`` =
    ``tune``/``store``); with no measurement the roofline placement
    decides: memory-bound folds are transfer-starved, so take larger
    chunks (deeper amortization) up to the residency budget across the
    prefetch pipeline; compute-bound folds keep the moderate default —
    chunk size barely moves their wall, and smaller chunks preempt
    sooner. Always bounded by the dataset and a power-of-two grid (one
    compiled shape family)."""
    measured = _store_rate(store, chain)
    if measured is not None and measured[2]:
        _rate, source, chunk, prefetch = measured
        return int(chunk), int(prefetch or 2), source

    price = price_stream_fold(rows, width, classes, chain=chain, store=None, device=device)
    base = int(default or 4096)
    prefetch = 2
    if price.roofline == "memory-bound":
        # Budget covers prefetch+in-flight staged chunks, double-buffered.
        per_row = 4.0 * (max(width, 1) + max(classes, 1))
        prefetch = 4
        cap = int(_residency_budget_bytes(device) / (per_row * (prefetch + 1)))
        chunk = base
        while chunk * 2 <= min(cap, 65536):
            chunk *= 2
    else:
        chunk = base
    chunk = max(min(chunk, max(int(rows), 1)), 1)
    return chunk, prefetch, "roofline"
