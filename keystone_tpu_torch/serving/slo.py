"""SLO controller: drive the admission ladder from *observed p99*, not
queue depth. A copy of ``keystone_tpu/serving/slo.py``.

Queue depth is a proxy signal — it says how much work is waiting, not
whether the latency objective is being met. A straggling worker can hold
p99 far over target while every queue stays shallow (each request waits
on a slow apply, not on the queue), and a fast worker can run deep queues
well inside target. The multi-worker supervisor therefore runs its
:class:`~keystone_tpu_torch.serving.admission.AdmissionController` in
*external* mode and lets this controller pin the rung:

    worker heartbeats ──► per-worker p99 ──► worst p99 vs target
                                                  │
                     degrade (shed earlier) ◄── over target
                     recover (after settle) ◄── under target × recover_factor

Transitions are rate-limited (``cooldown_s`` between degrades, and a
sustained ``settle_s`` under the recovery threshold before stepping
back up) so a single slow batch doesn't flap the ladder. Every
transition lands one ``slo`` event in the recovery ledger — the same
place solver block-size drops and depth-driven admission degradations
live — and the observed/target/rung state is continuously published as
``keystone_serving_slo_*`` metrics.

Imports no torch: it runs in the supervisor's process, which holds no
model.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..obs import names as _names
from ..reliability.recovery import get_recovery_log
from .admission import AdmissionController, AdmissionRung

# External-mode rung set: the NORMAL rung admits to the full capacity
# bound; degraded rungs admit to shrinking fractions — under a violated
# latency SLO the way to recover p99 is to take LESS work, loudly,
# rather than to queue more. wait_scale still forwards to batch
# assembly wherever the holder consults it.
SLO_RUNGS = (
    AdmissionRung(queue_frac=1.0, wait_scale=1.0, name="normal"),
    AdmissionRung(queue_frac=0.6, wait_scale=0.5, name="pressure"),
    AdmissionRung(queue_frac=0.3, wait_scale=0.25, name="overload"),
)


class SLOController:
    """Watches per-worker p99 snapshots and pins the admission rung.

    ``observe`` is called by the supervisor's monitor loop with the
    latest per-worker telemetry snapshots (the dicts workers put in
    their heartbeats — ``p99_ms`` and ``served`` are the fields read).
    The *aggregate* signal is the worst per-worker p99: one straggler
    violating the objective IS the fleet violating it (p99 over workers
    is bounded below by the slowest worker's p99 once that worker takes
    a meaningful traffic share).
    """

    def __init__(
        self,
        admission: AdmissionController,
        target_p99_ms: float,
        recover_factor: float = 0.5,
        cooldown_s: float = 1.0,
        settle_s: float = 3.0,
        min_served: int = 16,
        clock: Callable[[], float] = time.monotonic,
        label: str = "serving-slo",
    ):
        if target_p99_ms <= 0:
            raise ValueError(f"target_p99_ms must be > 0, got {target_p99_ms}")
        if not admission.external:
            raise ValueError(
                "SLOController requires an external-mode AdmissionController "
                "(its depth-driven transitions would fight the SLO's)"
            )
        self.admission = admission
        self.target_p99_ms = target_p99_ms
        self.recover_factor = recover_factor
        self.cooldown_s = cooldown_s
        self.settle_s = settle_s
        self.min_served = min_served
        self.label = label
        self._clock = clock
        self._last_transition_at = -float("inf")
        self._under_since: Optional[float] = None
        self._last_served: Dict[str, int] = {}
        self.transitions = 0
        #: worst fresh per-worker p99 from the latest observe sweep —
        #: the headroom signal the mesh co-scheduler reads (ROADMAP 13b).
        self.last_p99_ms: Optional[float] = None
        self._g_p99 = _names.metric(_names.SERVING_SLO_P99_MS)
        self._g_target = _names.metric(_names.SERVING_SLO_TARGET_MS)
        self._g_rung = _names.metric(_names.SERVING_SLO_RUNG)
        self._c_transitions = _names.metric(_names.SERVING_SLO_TRANSITIONS)
        self._g_target.set(target_p99_ms)
        self._g_rung.set(admission.rung_index)

    # ----------------------------------------------------------------- observe
    def observe(self, worker_stats: Dict[str, Dict]) -> Optional[Dict]:
        """Feed one sweep of per-worker telemetry snapshots; returns the
        transition record if the ladder moved, else None."""
        now = self._clock()
        worst: Optional[float] = None
        for worker, stats in worker_stats.items():
            p99 = stats.get("p99_ms")
            served = int(stats.get("served", 0) or 0)
            if p99 is None:
                continue
            self._g_p99.set(float(p99), worker=str(worker))
            # A worker that served nothing since the last sweep reports a
            # stale window — its p99 is history, not signal.
            if served < self.min_served or served == self._last_served.get(worker):
                continue
            self._last_served[worker] = served
            worst = p99 if worst is None else max(worst, p99)
        if worst is None:
            return None
        self.last_p99_ms = float(worst)
        self._g_p99.set(float(worst), worker="aggregate")

        index = self.admission.rung_index
        if worst > self.target_p99_ms:
            self._under_since = None
            if (
                index < len(self.admission.rungs) - 1
                and now - self._last_transition_at >= self.cooldown_s
            ):
                return self._transition(index, index + 1, "degrade", worst, now)
        elif worst < self.target_p99_ms * self.recover_factor and index > 0:
            if self._under_since is None:
                self._under_since = now
            if now - self._under_since >= self.settle_s:
                record = self._transition(index, index - 1, "recover", worst, now)
                self._under_since = now  # one rung per settle window
                return record
        else:
            self._under_since = None
        return None

    def _transition(
        self, old: int, new: int, direction: str, p99_ms: float, now: float
    ) -> Dict:
        self.admission.force_rung(new)
        self._last_transition_at = now
        self.transitions += 1
        self._g_rung.set(new)
        self._c_transitions.inc(direction=direction)
        record = {
            "direction": direction,
            "from_rung": self.admission.rungs[old].name,
            "to_rung": self.admission.rungs[new].name,
            "rung_index": new,
            "p99_ms": round(float(p99_ms), 3),
            "target_ms": self.target_p99_ms,
        }
        get_recovery_log().record("slo", self.label, **record)
        return record

    # --------------------------------------------------------------- headroom
    def headroom(self) -> Optional[float]:
        """Fraction of the p99 budget currently unspent, clamped to
        [0, 1]: 1.0 = serving far under target (the mesh is harvestable),
        0.0 = at/over target. None before the first fresh observation —
        the scheduler treats an absent signal as idle rather than
        wedging background work on a mesh nobody measured."""
        if self.last_p99_ms is None:
            return None
        return min(max(1.0 - self.last_p99_ms / self.target_p99_ms, 0.0), 1.0)

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict:
        return {
            "target_p99_ms": self.target_p99_ms,
            "rung": self.admission.rungs[self.admission.rung_index].name,
            "rung_index": self.admission.rung_index,
            "transitions": self.transitions,
            "last_p99_ms": self.last_p99_ms,
            "headroom": self.headroom(),
        }
