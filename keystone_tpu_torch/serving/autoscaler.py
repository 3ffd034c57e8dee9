"""Autoscaler: SLO pressure drives fleet size, not just admission.
A copy of ``keystone_tpu/serving/autoscaler.py``, with its timing
defaults sized to a worker on the card.

The :class:`~keystone_tpu_torch.serving.slo.SLOController` closes the loop
between observed p99 and the *admission ladder* — under pressure it
sheds. This module closes the second loop: under **sustained** pressure
it adds capacity (``WorkerSupervisor.add_worker``), and under sustained
idle it drains capacity away (``remove_worker`` → the draining/retire
machinery, zero dropped in-flight). Same measurement discipline as the
SLO controller:

- **fresh windows only** — a worker whose ``served`` count has not moved
  since the last step contributes no p99 (its percentile window is
  stale traffic, not current behavior);
- **hysteresis** — pressure must persist ``pressure_s`` before an up
  event, idle must persist ``idle_s`` before a down event (one slow
  batch must not spawn a worker);
- **cooldown** — at most one scale event per ``cooldown_s``, and never
  an event while a previous one is still settling (a booting worker
  counts toward capacity, a draining one does not);
- **bounds** — ``min_workers``/``max_workers`` cap both directions.

Every decision is observable: ``scale_up``/``scale_down`` recovery-ledger
events (recorded by the supervisor), ``keystone_serving_scale_*``
metrics, and flight-recorder marks. ``step()`` is synchronous and
clock-injected so tests drive the control law deterministically;
``start()`` runs it on a daemon thread for production. Imports no torch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import names as _names
from ..obs.flight import get_flight_recorder


@dataclass(frozen=True)
class AutoscalerConfig:
    """Scale-policy knobs.

    target_p99_ms  — the pressure line: sustained worst fresh-window
                     worker p99 above it (or a standing pending queue)
                     triggers scale-up.
    idle_factor    — the idle line as a fraction of target: p99 below
                     ``target_p99_ms * idle_factor`` (or no fresh
                     traffic at all) with an empty queue reads as idle.
    backlog_per_worker — the second pressure line: dispatched-but-
                     unanswered requests per unit of capacity above this
                     reads as overload even while reported percentiles
                     lag (a serial worker's window can look healthy
                     while its pipe backs up).
    pressure_s / idle_s — hysteresis: how long a condition must persist.
    cooldown_s     — minimum gap between scale events.
    min_workers / max_workers — hard fleet-size bounds.
    min_served     — percentile windows below this many requests are too
                     noisy to act on (same floor the SLO controller uses).
    check_interval_s — thread period for :meth:`Autoscaler.start`.

    The hysteresis and cooldown are the JAX package's ×2–4: a worker on
    the card takes ~8 s to start (interpreter, torch import, CUDA
    context, model load), so a cooldown shorter than that would add a
    second worker for the spike the first is still booting for.
    """

    target_p99_ms: float = 50.0
    min_workers: int = 1
    max_workers: int = 4
    backlog_per_worker: float = 8.0
    pressure_s: float = 1.0
    idle_s: float = 4.0
    idle_factor: float = 0.25
    cooldown_s: float = 8.0
    min_served: int = 16
    check_interval_s: float = 0.1


class Autoscaler:
    """The control loop between a :class:`WorkerSupervisor` and its size."""

    def __init__(
        self,
        supervisor: Any,
        config: Optional[AutoscalerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.supervisor = supervisor
        self.config = config or AutoscalerConfig()
        if self.config.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.config.max_workers < self.config.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        self._clock = clock
        self._last_served: Dict[str, float] = {}
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_event_at: Optional[float] = None
        #: (direction, worker_id, at) for every event this loop caused.
        self.events: List[Tuple[str, str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_target = _names.metric(_names.SERVING_SCALE_TARGET_WORKERS)
        self._m_target.set(self._clamp(self.config.min_workers))

    def _clamp(self, n: int) -> int:
        return max(self.config.min_workers, min(self.config.max_workers, n))

    # -------------------------------------------------------------- one step
    def _fresh_worst_p99(self, workers: Dict[str, Any]) -> Optional[float]:
        """Worst p99 across ready workers with a FRESH, big-enough
        window; None when nothing qualifies. Updates the staleness
        cursor as a side effect."""
        worst: Optional[float] = None
        for worker_id, row in workers.items():
            if row.get("state") != "ready":
                continue
            stats = row.get("stats") or {}
            served = stats.get("served")
            p99 = stats.get("p99_ms")
            if not isinstance(served, (int, float)):
                continue
            fresh = served != self._last_served.get(worker_id)
            self._last_served[worker_id] = served
            if (
                not fresh
                or served < self.config.min_served
                or not isinstance(p99, (int, float))
            ):
                continue
            worst = p99 if worst is None else max(worst, p99)
        return worst

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """Observe the fleet once and maybe scale. Returns
        ``"up:<worker_id>"`` / ``"down:<worker_id>"`` when an event
        fired, else None."""
        now = self._clock() if now is None else now
        stats = self.supervisor.stats()
        sup = stats.get("supervisor", {})
        workers: Dict[str, Any] = stats.get("workers", {})
        alive = sup.get("alive", 0)
        booting = sup.get("booting", 0)
        draining = sup.get("draining", 0)
        pending = sup.get("pending", 0)
        # Booting workers count toward capacity: pressure during a boot
        # must not spawn a second worker for the same spike.
        capacity = alive + booting
        worst_p99 = self._fresh_worst_p99(workers)
        inflight = sum(
            row.get("inflight", 0)
            for row in workers.values()
            if row.get("state") == "ready"
        )
        backlog = inflight / max(capacity, 1)
        self._m_target.set(self._clamp(capacity))

        pressure = (
            (worst_p99 is not None and worst_p99 > self.config.target_p99_ms)
            or backlog > self.config.backlog_per_worker
            or pending > 0
        )
        idle = (
            pending == 0
            and backlog <= 1.0
            and (
                worst_p99 is None
                or worst_p99
                < self.config.target_p99_ms * self.config.idle_factor
            )
        )
        # Explicit None checks: a monotonic clock CAN read 0.0 (tests
        # inject one), and `since or now` would silently reset the timer.
        if not pressure:
            self._pressure_since = None
        elif self._pressure_since is None:
            self._pressure_since = now
        if not idle:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        in_cooldown = (
            self._last_event_at is not None
            and now - self._last_event_at < self.config.cooldown_s
        )
        if in_cooldown:
            return None
        if (
            pressure
            and now - self._pressure_since >= self.config.pressure_s
            and capacity < self.config.max_workers
        ):
            worker_id = self.supervisor.add_worker(reason="slo_pressure")
            return self._fired("up", worker_id, now, capacity + 1)
        if (
            idle
            and now - self._idle_since >= self.config.idle_s
            and booting == 0
            and draining == 0
            and capacity > self.config.min_workers
        ):
            worker_id = self.supervisor.remove_worker(reason="idle")
            if worker_id is None:
                return None  # nothing sparable right now; try next step
            return self._fired("down", worker_id, now, capacity - 1)
        return None

    def _fired(
        self, direction: str, worker_id: str, now: float, target: int
    ) -> str:
        self._last_event_at = now
        self._pressure_since = None
        self._idle_since = None
        self.events.append((direction, worker_id, now))
        self._m_target.set(self._clamp(target))
        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.mark(
                "autoscale", direction=direction, worker=worker_id,
                target=target,
            )
        return f"{direction}:{worker_id}"

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(
            target=self._loop, name="keystone-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                # The control loop must outlive a transient stats/scale
                # error (e.g. a stop() racing a step) — skip the tick.
                pass
            self._stop.wait(self.config.check_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        return {
            "target_p99_ms": self.config.target_p99_ms,
            "min_workers": self.config.min_workers,
            "max_workers": self.config.max_workers,
            "events": [
                {"direction": d, "worker": w, "at": round(t, 3)}
                for d, w, t in self.events
            ],
            "scale_ups": sum(1 for d, _, _ in self.events if d == "up"),
            "scale_downs": sum(1 for d, _, _ in self.events if d == "down"),
        }
