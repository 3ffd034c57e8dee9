"""Process-wide recovery ledger: every retry, degradation and injected
fault lands here so a run can report HOW it survived, not just that it
did.

A copy of ``keystone_tpu/reliability/recovery.py`` without the
flight-recorder hook (``obs/flight.py``, fleet-plane machinery the port
does not have yet). ``QuarantineCounts`` is the loaders' skip-and-
quarantine tally, which ``publish``es its total into the ledger.

The log is module-global (like ``PipelineEnv``) and reset alongside it —
``PipelineEnv.reset()`` clears both, so tests stay isolated without a
second fixture.

The ledger is also a *publisher*: every ``record()`` increments the
``keystone_reliability_events_total{kind=...}`` counter and, when a span
session is active, attaches a ``reliability:<kind>`` event to the
current span.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..obs import names as _names
from ..obs import spans as _spans


@dataclass
class RecoveryEvent:
    kind: str  # "retry" | "retry_abandoned" | "degrade" | "fault"
    label: str
    detail: Dict[str, Any] = field(default_factory=dict)


class RecoveryLog:
    """Thread-safe append-only event list with a summarizing view."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[RecoveryEvent] = []

    def record(self, kind: str, label: str, **detail: Any) -> None:
        with self._lock:
            self._events.append(RecoveryEvent(kind, label, dict(detail)))
        # Publish beyond the ledger: counter always (cheap), span event
        # only under an active trace session (free otherwise).
        _names.metric(_names.RELIABILITY_EVENTS).inc(kind=kind)
        _spans.add_span_event(f"reliability:{kind}", label=label, **{
            k: v for k, v in detail.items()
            if isinstance(v, (bool, int, float, str))
        })

    def events(self, kind: str = None) -> List[RecoveryEvent]:
        with self._lock:
            return [e for e in self._events if kind is None or e.kind == kind]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def summary(self) -> Dict[str, Any]:
        """The shape run results embed: counts per kind plus compact events.

        ``quarantined_records`` sums record counts (one quarantine event may
        cover a whole batch of skipped records). ``checkpoint_hits`` keeps
        the JAX package's shape; the port has no checkpoint store yet, so
        no event of that kind is recorded.
        """
        with self._lock:
            events = list(self._events)
        out: Dict[str, Any] = {
            "retries": sum(1 for e in events if e.kind == "retry"),
            "degradations": sum(1 for e in events if e.kind == "degrade"),
            "checkpoint_hits": sum(1 for e in events if e.kind == "checkpoint_hit"),
            "quarantined_records": sum(
                int(e.detail.get("count", 1)) for e in events if e.kind == "quarantine"
            ),
        }
        out["events"] = [
            {"kind": e.kind, "label": e.label, **e.detail} for e in events[-50:]
        ]
        return out


_log = RecoveryLog()


def get_recovery_log() -> RecoveryLog:
    return _log


def reset_recovery_log() -> None:
    _log.clear()


class QuarantineCounts:
    """Skip-and-quarantine tally shared by the data loaders: per-reason
    counts plus the first few offending names for the audit trail.
    Attach ``as_dict()`` to the returned dataset and ``publish`` the total
    into the recovery log so run results surface how many records a
    'successful' ingest actually dropped."""

    def __init__(self, max_examples: int = 8):
        self.counts: Dict[str, int] = {}
        self.examples: List[str] = []
        self._max_examples = max_examples
        # add() may run from loader thread pools; an unlocked
        # read-modify-write would drop counts.
        self._lock = threading.Lock()

    def add(self, reason: str, name: str) -> None:
        with self._lock:
            self.counts[reason] = self.counts.get(reason, 0) + 1
            if len(self.examples) < self._max_examples:
                self.examples.append(name)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def as_dict(self) -> Dict[str, Any]:
        return {
            "quarantined": self.total,
            **self.counts,
            "examples": list(self.examples),
        }

    def publish(self, label: str, **extra: Any) -> None:
        if self.total:
            get_recovery_log().record(
                "quarantine", label, count=self.total,
                examples=list(self.examples), **self.counts, **extra,
            )
