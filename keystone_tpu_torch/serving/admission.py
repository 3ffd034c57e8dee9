"""Admission control: queue-depth backpressure with a DegradationLadder-
driven shed policy. A copy of ``keystone_tpu/serving/admission.py``.

The same mindset as the solver OOM ladders (reliability/degrade.py):
when the full-service configuration doesn't fit, take the best rung that
does and SAY SO. Here the scarce resource is queue room rather than HBM,
and the rungs are service levels —

    rung 0  normal    admit while depth < queue_frac·capacity, full wait
    rung 1  pressure  admit deeper, but trim the assembly wait (bigger
                      batches ship sooner; per-request latency budget is
                      spent on the queue, not on holding batches open)
    rung 2  overload  admit to the brim with minimal wait

A request that no rung admits is SHED with :class:`RequestShed` — the
queue never grows past capacity, so sustained overload degrades latency
in stages and then refuses loudly instead of queueing unboundedly.

Rung *transitions* (not per-request admits) run through the shared
:class:`~keystone_tpu_torch.reliability.degrade.DegradationLadder`, so each
degradation lands one ``degrade`` event in the recovery ledger exactly
like a solver shrinking its block size — bounded log growth even under a
shed storm, and ``summary()["degradations"]`` counts service-level drops
across training and serving alike.

Two sources of rung transitions share this controller:

- **depth mode** (default, the in-process server): each ``admit`` walks
  the rung whose ``queue_frac`` bound the current depth satisfies —
  queue depth IS the overload signal.
- **external mode** (the JAX package's multi-worker supervisor, not
  ported yet): rung transitions come only from :meth:`force_rung` — an
  SLO controller pins the rung from *observed p99 vs target*, and
  ``admit`` just enforces the pinned rung's depth bound. Rungs then read
  inverted: the normal rung admits to the full bound and degraded rungs
  admit to SHRINKING fractions (shedding earlier is how a latency SLO is
  defended).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..reliability.degrade import DegradationLadder
from .config import RequestShed


@dataclass(frozen=True)
class AdmissionRung:
    """One service level: admit below ``queue_frac``·capacity, scale the
    batcher's max-wait by ``wait_scale``."""

    queue_frac: float
    wait_scale: float
    name: str = "rung"


DEFAULT_RUNGS = (
    AdmissionRung(queue_frac=0.5, wait_scale=1.0, name="normal"),
    AdmissionRung(queue_frac=0.75, wait_scale=0.5, name="pressure"),
    AdmissionRung(queue_frac=1.0, wait_scale=0.25, name="overload"),
)


class _OverCapacity(RuntimeError):
    """Internal: this rung's depth bound is exceeded (degradable)."""


class AdmissionController:
    """Decides, per submit, whether to enqueue and at what service level."""

    def __init__(
        self,
        capacity: int,
        rungs: Sequence[AdmissionRung] = DEFAULT_RUNGS,
        label: str = "serving-admission",
        external: bool = False,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        fracs = [r.queue_frac for r in rungs]
        if not external and fracs != sorted(fracs):
            # Depth mode searches rungs shallow→deep, which only makes
            # sense for non-decreasing bounds; externally-driven rungs
            # are pinned by index, so any monotonicity (an SLO ladder
            # shrinks) is legal.
            raise ValueError("rung queue_fracs must be non-decreasing")
        self.external = external
        self.capacity = capacity
        self.rungs: List[AdmissionRung] = list(rungs)
        self.label = label
        self._lock = threading.Lock()
        self._rung_index = 0
        # One ladder for the controller's lifetime; walked (under _lock)
        # only on service-level transitions, where its reduced-success
        # bookkeeping lands the standard `degrade` ledger event.
        self._ladder = DegradationLadder(
            self.rungs,
            should_degrade=lambda e: isinstance(e, _OverCapacity),
            label=label,
        )
        self.sheds = 0
        self.consecutive_sheds = 0
        self.admitted = 0

    # ---------------------------------------------------------------- policy
    def _match_index(self, depth: int) -> Optional[int]:
        for i, rung in enumerate(self.rungs):
            if depth < rung.queue_frac * self.capacity:
                return i
        return None

    def admit(self, depth: int) -> AdmissionRung:
        """Admit a request at queue depth ``depth`` or raise
        :class:`RequestShed`. Returns the service-level rung in effect."""
        with self._lock:
            if self.external:
                # Externally-pinned rung (SLOController): enforce its
                # bound, never walk. The rung only changes via force_rung.
                rung = self.rungs[self._rung_index]
                if depth >= rung.queue_frac * self.capacity:
                    self.sheds += 1
                    self.consecutive_sheds += 1
                    raise RequestShed(
                        f"depth {depth} >= {rung.queue_frac:g}x{self.capacity} "
                        f"at SLO rung {rung.name!r}"
                    )
                self.admitted += 1
                self.consecutive_sheds = 0
                return rung
            index = self._match_index(depth)
            if index is None:
                self.sheds += 1
                self.consecutive_sheds += 1
                raise RequestShed(
                    f"queue depth {depth}/{self.capacity} at every rung "
                    f"({self.consecutive_sheds} consecutive)"
                )
            if index != self._rung_index:
                # Walk the ladder only on transitions: one recovery-ledger
                # event per service-level change, not per request. The
                # walk re-evaluates the same depth _match_index matched,
                # so it lands on `index` by construction — the ladder is
                # here for its degradation bookkeeping, not the search.
                def attempt(rung: AdmissionRung) -> AdmissionRung:
                    if depth >= rung.queue_frac * self.capacity:
                        raise _OverCapacity(
                            f"depth {depth} >= {rung.queue_frac:g}x{self.capacity}"
                        )
                    return rung

                self._ladder.run(attempt)
                self._rung_index = index
            self.admitted += 1
            self.consecutive_sheds = 0
            return self.rungs[self._rung_index]

    def force_rung(self, index: int) -> Optional[int]:
        """Pin the service level to ``index`` (external callers — the SLO
        controller). Returns the PREVIOUS index, or None when already
        there. Ledger/metric accounting for the transition belongs to
        the caller, which knows WHY it moved."""
        if not 0 <= index < len(self.rungs):
            raise ValueError(
                f"rung index {index} out of range 0..{len(self.rungs) - 1}"
            )
        with self._lock:
            previous = self._rung_index
            if previous == index:
                return None
            self._rung_index = index
            return previous

    # -------------------------------------------------------------- observers
    @property
    def rung_index(self) -> int:
        with self._lock:
            return self._rung_index

    def wait_scale(self) -> float:
        """Assembly-wait multiplier for the current service level — the
        batcher reads this each batch so sustained pressure ships batches
        sooner."""
        with self._lock:
            return self.rungs[self._rung_index].wait_scale

    def stats(self) -> dict:
        with self._lock:
            return {
                "rung": self.rungs[self._rung_index].name,
                "rung_index": self._rung_index,
                "admitted": self.admitted,
                "sheds": self.sheds,
                "consecutive_sheds": self.consecutive_sheds,
            }
