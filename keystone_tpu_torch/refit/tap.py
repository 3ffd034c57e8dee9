"""The traffic tap: a bounded spill buffer between serving and refit.

Port of ``keystone_tpu/refit/tap.py``. Rows are kept as host numpy
arrays: a tensor payload (a CUDA one included) is copied to the host
when it is kept.

The serve path is sacred — nothing the refit loop does may add latency
to a request. So the tap is a pair of bounded host-numpy ring buffers
behind one lock, with O(1) non-blocking ``offer`` semantics:

- ``feed(x, y)``   — the LABELED side-channel (delayed labels, human
                     review, a downstream join): the rows the refit
                     daemon actually trains on.
- ``observe(x)``   — sampled served payloads (no labels): the mirror
                     set the shadow evaluator uses to compare candidate
                     vs incumbent predictions on real live traffic.

Backpressure is drop-oldest with loud accounting, never blocking: a
slow (or dead) refit daemon means the buffer wraps and the
``keystone_refit_tap_rows_total{status="dropped"}`` counter climbs —
and serving latency does not move.
Drop-OLDEST is deliberate: under drift the freshest rows are the ones
worth keeping.

Hook point (opt-in, default-off): ``PipelineServer(..., tap=...)``
samples settled request payloads into ``observe`` after each batch (off
the submit hot path — the batch worker thread pays one lock + copy per
sampled row). ``WorkerSupervisor(..., tap=...)`` samples each accepted
payload at submit, the one place that sees every request of a fleet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import names as _names


def _host(x: Any) -> np.ndarray:
    """``x`` as a host numpy array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TrafficTap:
    """Bounded labeled + mirror buffers with drop-counting backpressure."""

    def __init__(
        self,
        capacity_rows: int = 65536,
        mirror_rows: int = 1024,
        sample_every: int = 1,
    ):
        self.capacity_rows = max(1, int(capacity_rows))
        self.mirror_capacity = max(1, int(mirror_rows))
        #: keep 1-in-N served payloads in the mirror set (labeled feeds
        #: are never sampled — labels are too expensive to discard at
        #: the door; the bound handles overload).
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._labeled: List[Tuple[np.ndarray, np.ndarray]] = []
        self._mirror: List[np.ndarray] = []
        self._seen = 0
        self.fed = 0
        self.mirrored = 0
        self.dropped = 0
        self._m_rows = _names.metric(_names.REFIT_TAP_ROWS)

    # ------------------------------------------------------------------ doors
    def feed(self, x: Any, y: Any) -> int:
        """Offer labeled rows (one row, or a stacked batch). Returns how
        many rows were RETAINED after the bound dropped the oldest.
        Never blocks; never raises on full."""
        xs = np.atleast_2d(_host(x))
        ys = _host(y)
        if ys.ndim == 0:
            ys = ys.reshape(1)
        if ys.ndim == 1:
            # 1-D labels are one scalar label PER ROW (the class-label
            # form shadow eval supports) — except the single-row case,
            # where a length-k vector is that row's label vector.
            if ys.shape[0] == xs.shape[0] and xs.shape[0] != 1:
                ys = ys[:, None]
            else:
                ys = ys.reshape(1, -1)
        if ys.shape[0] != xs.shape[0]:
            # Misaligned batches are a caller bug worth refusing quietly
            # here (the serve path must never crash on a tap error).
            return 0
        rows = list(zip(xs, ys))
        with self._lock:
            self._labeled.extend(rows)
            overflow = len(self._labeled) - self.capacity_rows
            if overflow > 0:
                del self._labeled[:overflow]  # drop-OLDEST: keep fresh
            self.fed += len(rows)
            retained = len(rows) - max(overflow, 0)
            if overflow > 0:
                self.dropped += overflow
        self._m_rows.inc(len(rows), status="labeled")
        if overflow > 0:
            self._m_rows.inc(overflow, status="dropped")
        return max(retained, 0)

    def observe(self, x: Any) -> bool:
        """Sample one served payload into the mirror set (1-in-N).
        Returns True when the row was kept. O(1), non-blocking."""
        with self._lock:
            self._seen += 1
            if self._seen % self.sample_every:
                return False
            try:
                row = _host(x)
            except Exception:
                return False  # unstackable payloads just aren't mirrored
            self._mirror.append(row)
            if len(self._mirror) > self.mirror_capacity:
                del self._mirror[: len(self._mirror) - self.mirror_capacity]
            self.mirrored += 1
        self._m_rows.inc(status="mirrored")
        return True

    def observe_batch(self, payloads: Any) -> None:
        for p in payloads:
            self.observe(p)

    # ------------------------------------------------------------------ drain
    def drain(self, max_rows: Optional[int] = None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Take up to ``max_rows`` labeled rows (oldest first) out of the
        buffer as stacked ``(x, y)`` float32 matrices; None when empty.
        Rows whose shapes disagree with the MAJORITY shape of the drain
        are dropped (and counted) rather than poisoning the stack — or
        worse, being requeued to become the next drain's reference shape
        and starve it down to the anomalous minority."""
        with self._lock:
            if not self._labeled:
                return None
            take = len(self._labeled) if max_rows is None else min(
                max_rows, len(self._labeled)
            )
            rows = self._labeled[:take]
            self._labeled = self._labeled[take:]
            shapes: Dict[Any, int] = {}
            for r in rows:
                key = (r[0].shape, r[1].shape)
                shapes[key] = shapes.get(key, 0) + 1
            majority = max(shapes, key=shapes.get)
            keep = [r for r in rows if (r[0].shape, r[1].shape) == majority]
            misfits = len(rows) - len(keep)
            self.dropped += misfits
        if misfits:
            self._m_rows.inc(misfits, status="dropped")
        x = np.stack([r[0] for r in keep]).astype(np.float32)
        y = np.stack([r[1] for r in keep]).astype(np.float32)
        return x, y

    def mirror(self, max_rows: Optional[int] = None) -> Optional[np.ndarray]:
        """A COPY of the freshest mirrored payloads (they stay buffered —
        shadow evaluation reads them, it doesn't consume them)."""
        with self._lock:
            if not self._mirror:
                return None
            rows = self._mirror[-(max_rows or len(self._mirror)):]
            shape = rows[-1].shape
            rows = [r for r in rows if r.shape == shape]
        return np.stack(rows).astype(np.float32)

    # ------------------------------------------------------------------ stats
    def depth(self) -> int:
        with self._lock:
            return len(self._labeled)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "labeled_depth": len(self._labeled),
                "mirror_depth": len(self._mirror),
                "fed": self.fed,
                "mirrored": self.mirrored,
                "dropped": self.dropped,
                "capacity_rows": self.capacity_rows,
            }
