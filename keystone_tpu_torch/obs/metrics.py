"""Metrics registry: labeled counters, gauges, and histograms with a
Prometheus-compatible data model.

A copy of ``keystone_tpu/obs/metrics.py``: one process-wide registry
(:func:`get_registry`) that the serving telemetry and the recovery
ledger publish into.

Histograms keep BOTH cumulative buckets (for Prometheus ``_bucket``
export) and a bounded sample window, so :meth:`Histogram.percentile`
reproduces exactly the linear-interpolated percentiles
``ServingTelemetry`` reports.

Stdlib-only at import time; thread-safe (one lock per metric — the
serving hot path increments a handful per request).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of ``samples``.

    The canonical implementation — ``serving.telemetry`` re-exports it, so
    every percentile the system reports interpolates the same way.
    """
    if not samples:
        return 0.0
    data = sorted(samples)
    if len(data) == 1:
        return float(data[0])
    rank = (q / 100.0) * (len(data) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return float(data[lo] * (1.0 - frac) + data[hi] * frac)


# Latency-oriented default buckets (seconds), sub-ms to minutes.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)
# Ratio-oriented buckets (occupancy, hit rates).
RATIO_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)


def _label_key(label_names: Tuple[str, ...], labels: Dict[str, Any]) -> LabelKey:
    if tuple(sorted(labels)) != tuple(sorted(label_names)):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared {sorted(label_names)}"
        )
    return tuple((k, str(labels[k])) for k in label_names)


class Metric:
    """Base: name, help text, declared label names, per-series storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Any] = {}

    def series(self) -> Dict[LabelKey, Any]:
        with self._lock:
            return dict(self._series)


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def max(self, value: float, **labels: Any) -> None:
        """Keep the running maximum (peak-memory style gauges)."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = max(self._series.get(key, float("-inf")), float(value))

    def value(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class _HistogramSeries:
    __slots__ = ("bucket_counts", "sum", "count", "window")

    def __init__(self, num_buckets: int, window: int):
        self.bucket_counts = [0] * (num_buckets + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0
        self.window: deque = deque(maxlen=window)


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        window: int = 2048,
    ):
        super().__init__(name, help, labels)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.window = window

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(
                    len(self.buckets), self.window
                )
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    idx = i
                    break
            series.bucket_counts[idx] += 1
            series.sum += value
            series.count += 1
            series.window.append(value)

    def percentile(self, q: float, **labels: Any) -> float:
        """Linear-interpolated percentile over the bounded sample window —
        the exact math ``ServingTelemetry`` snapshots always used."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            samples = list(series.window) if series is not None else []
        return percentile(samples, q)

    def count(self, **labels: Any) -> int:
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            return series.count if series is not None else 0

    def sum(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            return series.sum if series is not None else 0.0


class MetricsRegistry:
    """Name → metric table with idempotent get-or-create registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels: Sequence[str], **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}, requested "
                        f"{cls.kind}{tuple(labels)}"
                    )
                return existing
            metric = cls(name, help=help, labels=labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        window: int = 2048,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets, window=window
        )

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{k=v,...}`` → value view: counters/gauges directly,
        histograms as ``_count`` and ``_sum``; :func:`delta` diffs two
        of them."""
        out: Dict[str, float] = {}
        for metric in self.collect():
            for key, value in metric.series().items():
                labels = ",".join(f"{k}={v}" for k, v in key)
                suffix = "{" + labels + "}" if labels else ""
                if isinstance(metric, Histogram):
                    out[f"{metric.name}_count{suffix}"] = float(value.count)
                    out[f"{metric.name}_sum{suffix}"] = round(value.sum, 6)
                else:
                    out[f"{metric.name}{suffix}"] = round(float(value), 6)
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def delta(
    after: Dict[str, float], before: Dict[str, float]
) -> Dict[str, float]:
    """Changed-series view between two :meth:`MetricsRegistry.snapshot`
    calls: every key whose value moved, as ``after − before`` (new keys
    count from 0)."""
    out: Dict[str, float] = {}
    for key, value in after.items():
        prev = before.get(key, 0.0)
        if value != prev:
            out[key] = round(value - prev, 6)
    return out


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def reset_registry() -> None:
    """Testing hook: drop every registered metric. Cached metric handles
    held by long-lived objects keep working but detach from the registry —
    modules that cache handles must re-resolve via their accessor."""
    _registry.reset()
