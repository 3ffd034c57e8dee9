"""Seeded load generation: the arrival processes production actually sees.
A copy of ``keystone_tpu/serving/loadgen.py``.

Uniform offered load never exercises an autoscaler — the interesting
behaviors (scale-up under a spike, scale-down in the trough, tail
latency under correlated bursts) need arrival processes with structure.
Three generators, all seeded and purely host-side (stdlib only):

- :func:`diurnal_offsets` — inhomogeneous Poisson with a sinusoidal
  rate (the day/night cycle), sampled by thinning;
- :func:`bursty_offsets` — Markov on/off: quiet base-rate stretches
  punctuated by high-rate bursts (batchy clients, retry storms);
- :func:`heavy_tail_offsets` — Pareto inter-arrivals (bounded), the
  long-memory arrivals that make p99 live far from the mean.

Each returns sorted arrival offsets in seconds; :func:`run_load` replays
them against any ``submit``-shaped callable (PipelineServer or
WorkerSupervisor), optionally time-compressed, and reports rps,
latency percentiles, and the exact dropped/failed accounting the
autoscaling phase of ``chip_smoke.py`` gates on (``dropped == 0`` is the
fleet invariant under scale events).
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .telemetry import percentile


def diurnal_offsets(
    duration_s: float,
    base_rps: float,
    peak_rps: float,
    period_s: Optional[float] = None,
    seed: int = 0,
) -> List[float]:
    """Inhomogeneous Poisson arrivals whose rate swings sinusoidally
    between ``base_rps`` and ``peak_rps`` over ``period_s`` (default: one
    full cycle across the duration). Thinning: draw at the peak rate,
    keep with probability rate(t)/peak."""
    if peak_rps < base_rps:
        raise ValueError("peak_rps must be >= base_rps")
    period_s = period_s or duration_s
    rng = random.Random(seed)
    out: List[float] = []
    t = 0.0
    lam = max(peak_rps, 1e-9)
    while True:
        t += rng.expovariate(lam)
        if t >= duration_s:
            return out
        mid = (base_rps + peak_rps) / 2.0
        swing = (peak_rps - base_rps) / 2.0
        rate = mid - swing * math.cos(2.0 * math.pi * t / period_s)
        if rng.random() < rate / lam:
            out.append(t)


def bursty_offsets(
    duration_s: float,
    base_rps: float,
    burst_rps: float,
    burst_len_s: float = 0.5,
    quiet_len_s: float = 2.0,
    seed: int = 0,
) -> List[float]:
    """Markov on/off arrivals: exponential-length quiet stretches at
    ``base_rps`` alternating with exponential-length bursts at
    ``burst_rps``."""
    rng = random.Random(seed)
    out: List[float] = []
    t = 0.0
    bursting = False
    phase_end = rng.expovariate(1.0 / quiet_len_s)
    while t < duration_s:
        rate = burst_rps if bursting else base_rps
        t += rng.expovariate(max(rate, 1e-9))
        while t >= phase_end:
            bursting = not bursting
            mean = burst_len_s if bursting else quiet_len_s
            phase_end += rng.expovariate(1.0 / mean)
        if t < duration_s:
            out.append(t)
    return out


def heavy_tail_offsets(
    duration_s: float,
    rps: float,
    alpha: float = 1.5,
    seed: int = 0,
) -> List[float]:
    """Pareto(``alpha``) inter-arrivals scaled to an average of ``rps``,
    capped at the duration (alpha <= 1 has no finite mean — refuse)."""
    if alpha <= 1.0:
        raise ValueError("alpha must be > 1 for a finite mean inter-arrival")
    rng = random.Random(seed)
    # Pareto mean is alpha/(alpha-1) * x_min; solve x_min for 1/rps.
    x_min = (1.0 / rps) * (alpha - 1.0) / alpha
    out: List[float] = []
    t = 0.0
    while True:
        t += min(x_min * rng.paretovariate(alpha), duration_s)
        if t >= duration_s:
            return out
        out.append(t)


@dataclass
class LoadReport:
    """What one replay measured. ``dropped`` counts requests that never
    got an answer value — shed, expired, or failed; the autoscale gates
    require it to be exactly 0."""

    offered: int = 0
    completed: int = 0
    dropped: int = 0
    duration_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    errors: Dict[str, int] = field(default_factory=dict)

    @property
    def rps(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    def p(self, q: float) -> float:
        return percentile(self.latencies_ms, q)

    def summary(self) -> Dict[str, Any]:
        return {
            "offered": self.offered,
            "completed": self.completed,
            "dropped": self.dropped,
            "rps": round(self.rps, 2),
            "duration_s": round(self.duration_s, 3),
            "p50_ms": round(self.p(50), 3),
            "p99_ms": round(self.p(99), 3),
            "errors": dict(self.errors),
        }


def run_load(
    submit: Callable[..., Any],
    offsets: List[float],
    payload: Callable[[int], Any],
    deadline_s: Optional[float] = None,
    time_scale: float = 1.0,
    settle_timeout_s: float = 60.0,
) -> LoadReport:
    """Replay ``offsets`` (compressed by ``time_scale`` — 0.1 runs a
    10-second trace in one) against ``submit(payload, deadline_s=...)``,
    which must return a Future. Blocks until every accepted request
    settles; latency is submit→result wall time."""
    report = LoadReport(offered=len(offsets))
    lock = threading.Lock()
    outstanding = threading.Semaphore(0)
    t0 = time.monotonic()
    accepted = 0
    for i, offset in enumerate(sorted(offsets)):
        wait = offset * time_scale - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        sent_at = time.monotonic()
        try:
            future = submit(payload(i), deadline_s=deadline_s)
        except Exception as exc:
            with lock:
                report.dropped += 1
                name = type(exc).__name__
                report.errors[name] = report.errors.get(name, 0) + 1
            continue
        accepted += 1

        def on_done(f, sent_at=sent_at) -> None:
            latency_ms = (time.monotonic() - sent_at) * 1e3
            with lock:
                try:
                    f.result()
                except Exception as exc:
                    report.dropped += 1
                    name = type(exc).__name__
                    report.errors[name] = report.errors.get(name, 0) + 1
                else:
                    report.completed += 1
                    report.latencies_ms.append(latency_ms)
            outstanding.release()

        future.add_done_callback(on_done)
    deadline = time.monotonic() + settle_timeout_s
    for _ in range(accepted):
        if not outstanding.acquire(timeout=max(deadline - time.monotonic(), 0.01)):
            with lock:
                report.dropped += 1
                report.errors["Unsettled"] = (
                    report.errors.get("Unsettled", 0) + 1
                )
    report.duration_s = time.monotonic() - t0
    return report
