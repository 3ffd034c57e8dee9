"""Process-wide recovery ledger: every retry, degradation and injected
fault lands here so a run can report HOW it survived, not just that it
did.

A copy of ``keystone_tpu/reliability/recovery.py`` without two parts:
the flight-recorder hook (``obs/flight.py``, fleet-plane machinery the
port does not have yet) and ``QuarantineCounts`` (the loaders' tally,
which waits for the loaders' wiring into the ledger).

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
        """The shape run results embed: counts per kind plus compact events."""
        with self._lock:
            events = list(self._events)
        out: Dict[str, Any] = {
            "retries": sum(1 for e in events if e.kind == "retry"),
            "degradations": sum(1 for e in events if e.kind == "degrade"),
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
