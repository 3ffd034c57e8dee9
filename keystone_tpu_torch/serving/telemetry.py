"""Serving telemetry: latency percentiles, batch occupancy, bucket-warmth
hit rate, shed/timeout counters.

A copy of ``keystone_tpu/serving/telemetry.py``. Snapshot-oriented
(``snapshot()`` returns a plain dict the CLI prints) plus a rate-limited
periodic log line for long-running servers. Stdlib-only.

The percentile math lives in :mod:`keystone_tpu_torch.obs.metrics`
(re-exported here unchanged), and every recording call ALSO publishes
into the process-wide metrics registry — ``keystone_serving_*`` counters
and histograms. Per-instance windows are kept for ``snapshot()`` so two
servers in one process don't blend their percentiles; the registry
series aggregate across servers, as process-level metrics should.

Every ``keystone_serving_*`` series carries a ``model`` label: a registry
hosting two tenants emits two distinct series per metric. Recording
calls without a model default the label to the telemetry's
``default_model``; ``snapshot()`` additionally reports a ``per_model``
breakdown of served/failure counts.

``bucket_compiles`` counts the first batch at each bucket the warmup did
not reach (on the card: a batch shape that may build a new cuFFT plan),
``bucket_hits`` every later one.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..obs import metrics as _metrics
from ..obs.metrics import RATIO_BUCKETS, percentile  # noqa: F401  (re-export)
from ..obs.names import (
    SERVING_BATCH_OCCUPANCY,
    SERVING_BATCHES,
    SERVING_BUCKET_COMPILES,
    SERVING_BUCKET_HITS,
    SERVING_FAILURES,
    SERVING_LATENCY_SECONDS,
    SERVING_QUEUE_WAIT_SECONDS,
    SERVING_REQUESTS,
    SERVING_RETRIES,
    SERVING_SHEDS,
    SERVING_TIMEOUTS,
)


class ServingTelemetry:
    """Thread-safe counters + bounded latency/occupancy windows."""

    def __init__(
        self,
        window: int = 2048,
        clock: Callable[[], float] = time.monotonic,
        log: Optional[logging.Logger] = None,
        default_model: str = "default",
    ):
        self._clock = clock
        self.default_model = default_model
        self._lock = threading.Lock()
        self._log = log or logging.getLogger("keystone_tpu_torch.serving")
        self._latencies_s: deque = deque(maxlen=window)
        self._queue_waits_s: deque = deque(maxlen=window)
        self._occupancies: deque = deque(maxlen=window)
        self._started_at = clock()
        self._last_log_at = clock()
        self.served = 0
        self.batches = 0
        self.sheds = 0
        self.timeouts = 0
        self.retries = 0
        self.failures = 0
        self.bucket_hits = 0      # batch padded to an already-warm bucket
        self.bucket_compiles = 0  # first batch at a cold bucket
        self._warm_buckets: set = set()
        # Per-model tallies for snapshot(): the tenant breakdown next to
        # the flat counters above.
        self._per_model: Dict[str, Dict[str, int]] = {}
        # Registry handles resolved once (hot-path: no name lookups per
        # request). These aggregate across all servers in the process,
        # one series per model.
        registry = _metrics.get_registry()
        labels = ("model",)
        self._m_requests = registry.counter(SERVING_REQUESTS, "Requests served to completion", labels)
        self._m_batches = registry.counter(SERVING_BATCHES, "Micro-batches dispatched", labels)
        self._m_sheds = registry.counter(SERVING_SHEDS, "Requests shed by admission control", labels)
        self._m_timeouts = registry.counter(SERVING_TIMEOUTS, "Requests expired before batch assembly", labels)
        self._m_retries = registry.counter(SERVING_RETRIES, "Apply-path retry attempts", labels)
        self._m_failures = registry.counter(SERVING_FAILURES, "Requests failed by apply errors", labels)
        self._m_bucket_hits = registry.counter(SERVING_BUCKET_HITS, "Batches padded onto an already-warm bucket", labels)
        self._m_bucket_compiles = registry.counter(SERVING_BUCKET_COMPILES, "First batches at a cold bucket", labels)
        self._m_latency = registry.histogram(SERVING_LATENCY_SECONDS, "End-to-end request latency", labels)
        self._m_queue_wait = registry.histogram(SERVING_QUEUE_WAIT_SECONDS, "Submit-to-apply queue wait", labels)
        self._m_occupancy = registry.histogram(
            SERVING_BATCH_OCCUPANCY, "Batch size / max_batch", labels, buckets=RATIO_BUCKETS
        )

    def _model(self, model: Optional[str]) -> str:
        return model if model else self.default_model

    def _tally(self, model: str, key: str, n: int = 1) -> None:
        # Callers hold self._lock.
        row = self._per_model.setdefault(model, {})
        row[key] = row.get(key, 0) + n

    # --------------------------------------------------------------- recording
    def record_request(
        self, latency_s: float, queue_wait_s: float, model: Optional[str] = None
    ) -> None:
        model = self._model(model)
        with self._lock:
            self.served += 1
            self._latencies_s.append(latency_s)
            self._queue_waits_s.append(queue_wait_s)
            self._tally(model, "served")
        self._m_requests.inc(model=model)
        self._m_latency.observe(latency_s, model=model)
        self._m_queue_wait.observe(queue_wait_s, model=model)

    def record_batch(
        self, size: int, bucket: int, max_batch: int, model: Optional[str] = None
    ) -> None:
        model = self._model(model)
        with self._lock:
            self.batches += 1
            self._occupancies.append(size / float(max_batch))
            if bucket in self._warm_buckets:
                self.bucket_hits += 1
                hit = True
            else:
                self._warm_buckets.add(bucket)
                self.bucket_compiles += 1
                hit = False
        self._m_batches.inc(model=model)
        self._m_occupancy.observe(size / float(max_batch), model=model)
        (self._m_bucket_hits if hit else self._m_bucket_compiles).inc(model=model)

    def mark_bucket_warm(self, bucket: int) -> None:
        """Pre-declare a bucket as warm (the warmup path), so the first
        real batch at it counts as a hit."""
        with self._lock:
            self._warm_buckets.add(bucket)

    def warmed_buckets(self) -> list:
        """The buckets currently known warm — the warm set the refit
        publish verifier (KV305) checks candidate bucket plans against."""
        with self._lock:
            return sorted(self._warm_buckets)

    def record_shed(self, model: Optional[str] = None) -> None:
        model = self._model(model)
        with self._lock:
            self.sheds += 1
            self._tally(model, "sheds")
        self._m_sheds.inc(model=model)

    def record_timeout(self, model: Optional[str] = None) -> None:
        model = self._model(model)
        with self._lock:
            self.timeouts += 1
            self._tally(model, "timeouts")
        self._m_timeouts.inc(model=model)

    def record_retry(self, model: Optional[str] = None) -> None:
        model = self._model(model)
        with self._lock:
            self.retries += 1
        self._m_retries.inc(model=model)

    def record_failure(self, n: int = 1, model: Optional[str] = None) -> None:
        model = self._model(model)
        with self._lock:
            self.failures += n
            self._tally(model, "failures", n)
        self._m_failures.inc(n, model=model)

    # --------------------------------------------------------------- snapshots
    def snapshot(self, queue_depth: Optional[int] = None) -> Dict[str, object]:
        with self._lock:
            lat = list(self._latencies_s)
            waits = list(self._queue_waits_s)
            occ = list(self._occupancies)
            uptime = self._clock() - self._started_at
            out: Dict[str, object] = {
                "served": self.served,
                "batches": self.batches,
                "sheds": self.sheds,
                "timeouts": self.timeouts,
                "retries": self.retries,
                "failures": self.failures,
                "uptime_s": round(uptime, 3),
                "throughput_rps": round(self.served / uptime, 2) if uptime > 0 else 0.0,
                "p50_ms": round(percentile(lat, 50) * 1e3, 3),
                "p95_ms": round(percentile(lat, 95) * 1e3, 3),
                "p99_ms": round(percentile(lat, 99) * 1e3, 3),
                "queue_wait_p50_ms": round(percentile(waits, 50) * 1e3, 3),
                "batch_occupancy": round(sum(occ) / len(occ), 4) if occ else 0.0,
                "bucket_hits": self.bucket_hits,
                "bucket_compiles": self.bucket_compiles,
                "bucket_hit_rate": round(
                    self.bucket_hits / max(1, self.bucket_hits + self.bucket_compiles), 4
                ),
            }
            if self._per_model:
                out["per_model"] = {
                    name: dict(row) for name, row in sorted(self._per_model.items())
                }
        if queue_depth is not None:
            out["queue_depth"] = queue_depth
        return out

    def maybe_log(self, interval_s: float, queue_depth: Optional[int] = None) -> bool:
        """Emit one INFO line at most every ``interval_s``; returns whether
        a line was emitted (the worker calls this once per batch)."""
        with self._lock:
            now = self._clock()
            if now - self._last_log_at < interval_s:
                return False
            self._last_log_at = now
        snap = self.snapshot(queue_depth=queue_depth)
        self._log.info(
            "serving: served=%d rps=%.1f p50=%.2fms p99=%.2fms occupancy=%.2f "
            "queue=%s sheds=%d timeouts=%d retries=%d bucket_hit_rate=%.2f",
            snap["served"], snap["throughput_rps"], snap["p50_ms"], snap["p99_ms"],
            snap["batch_occupancy"], snap.get("queue_depth", "?"), snap["sheds"],
            snap["timeouts"], snap["retries"], snap["bucket_hit_rate"],
        )
        return True
