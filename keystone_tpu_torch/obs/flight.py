"""Always-on flight recorder: a bounded per-process ring of recent
telemetry, dumped to a post-mortem artifact when something goes wrong.

A copy of ``keystone_tpu/obs/flight.py``. In the port the refit daemon,
the serving supervisor, its workers and the fleet's front-end install
it; a dump's ``perf_ledger`` holds the cost observatory's last 32
per-node entries (``obs/cost.py``).

"Worker died, requeued" is a healthy-system log line and a terrible
post-mortem: by the time a human looks, the spans, ledger events, and
counter values that explain *why* are gone. This module keeps the last
few hundred of each in bounded ring buffers — cheap enough to run
permanently in every process (supervisor, workers, the refit daemon) —
and writes one ``flightrec-<role>-<pid>.json`` artifact the moment a
trigger fires:

- ``worker_crash``   — the supervisor declared a worker dead (its view:
  the crash ledger event, last heartbeat stats, dispatch spans).
- ``fault_probe``    — an armed fault-injection probe fired in THIS
  process. A ``kill`` spec records the fault to the ledger *before*
  SIGKILLing, so the dump lands on disk and the killed worker leaves its
  own post-mortem.
- ``slo_degrade``    — the SLO controller stepped the admission ladder
  down (the latency objective was violated; capture why).
- ``refit_rollback`` — the post-publish watch window rolled a candidate
  back.
- ``quality_drift`` / ``quality_rollback`` — the quality plane detected
  an input/score drift, or its sequential gate decided ``rollback``
  (docs/OBSERVABILITY.md "Quality plane"). Quality events live in their
  own ``quality`` ring so the dump separates statistical evidence from
  the recovery ledger.

Triggers ride the recovery ledger: :func:`observe_ledger` is called by
``RecoveryLog.record`` for every event (a single global read when no
recorder is installed), appends to the ring, and auto-dumps on the
trigger kinds above. Dumps are rate-limited per trigger so a fault storm
produces one artifact, not a disk full of them.

Artifact schema (one JSON object)::

    {"flightrec": 1, "role": ..., "pid": ..., "trigger": ...,
     "written_unix": ..., "detail": {...},
     "spans": [<fleet span fragments, absolute-unix times>],
     "ledger": [{"kind", "label", "unix", ...detail}],
     "quality": [{"kind", "unix", ...evidence}],
     "metric_snapshots": [{"unix", "metrics": {...}}],
     "metrics": {<full registry snapshot at dump time>},
     "marks": [{"label", "unix", ...}], "dropped_spans": N}

Stdlib-only at import, like the rest of ``obs/``. The artifact directory
is ``KEYSTONE_FLIGHT_DIR`` (default: the system temp dir), documented in
docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..envknobs import env_raw
from . import names as _names
from . import spans as _spans
from .metrics import get_registry

#: ledger kind → dump trigger for unconditional triggers; ``slo`` events
#: trigger only on direction="degrade" (handled in observe_ledger).
TRIGGER_KINDS: Dict[str, str] = {
    "fault": "fault_probe",
    "worker_crash": "worker_crash",
    "refit_rollback": "refit_rollback",
}

FLIGHT_DIR_ENV = "KEYSTONE_FLIGHT_DIR"


def _json_safe_detail(detail: Dict[str, Any]) -> Dict[str, Any]:
    return {
        k: (v if isinstance(v, (bool, int, float, str)) or v is None else str(v))
        for k, v in detail.items()
    }


class FlightRecorder:
    """Bounded rings of recent ledger events / metric snapshots / marks,
    plus a dump method that also captures the active span session's
    tail. One per process, installed via :func:`install_flight_recorder`."""

    def __init__(
        self,
        role: str,
        capacity: int = 512,
        out_dir: Optional[str] = None,
        min_dump_interval_s: float = 1.0,
        metrics_interval_s: float = 1.0,
    ):
        self.role = role
        self.capacity = capacity
        self.out_dir = (
            out_dir or env_raw(FLIGHT_DIR_ENV) or tempfile.gettempdir()
        )
        self.min_dump_interval_s = min_dump_interval_s
        self.metrics_interval_s = metrics_interval_s
        self._lock = threading.Lock()
        self._ledger: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._quality: "deque[Dict[str, Any]]" = deque(maxlen=128)
        self._marks: "deque[Dict[str, Any]]" = deque(maxlen=64)
        self._metric_ring: "deque[Dict[str, Any]]" = deque(maxlen=8)
        self._last_metrics_at = -float("inf")
        self._last_dump_at: Dict[str, float] = {}
        #: dump history (trigger + path), for tests and TRACE_STATS lines.
        self.dumps: List[Dict[str, str]] = []
        self._m_records = _names.metric(_names.FLIGHT_RECORDS)
        self._m_dumps = _names.metric(_names.FLIGHT_DUMPS)
        self._m_dump_bytes = _names.metric(_names.FLIGHT_DUMP_BYTES)

    # -------------------------------------------------------------- recording
    def observe_ledger(self, kind: str, label: str, detail: Dict[str, Any]) -> None:
        entry = {
            "kind": kind,
            "label": label,
            "unix": round(time.time(), 6),
            **_json_safe_detail(detail),
        }
        with self._lock:
            self._ledger.append(entry)
        self._m_records.inc(kind="ledger")
        trigger = TRIGGER_KINDS.get(kind)
        if kind == "slo" and detail.get("direction") == "degrade":
            trigger = "slo_degrade"
        if trigger is not None:
            self.dump(trigger, detail={"kind": kind, "label": label})

    def observe_quality(self, event: Dict[str, Any]) -> None:
        """Append a quality-plane event (drift firing, gate decision) to
        the ``quality`` ring; a ``drift`` event or a ``rollback`` gate
        decision is a post-mortem moment and dumps immediately."""
        entry = {"unix": round(time.time(), 6), **_json_safe_detail(event)}
        with self._lock:
            self._quality.append(entry)
        self._m_records.inc(kind="quality")
        kind = event.get("kind")
        if kind == "drift":
            self.dump("quality_drift",
                      detail={"kind": "quality_drift",
                              "model": event.get("model", "")})
        elif kind == "gate_decision" and event.get("decision") == "rollback":
            self.dump("quality_rollback",
                      detail={"kind": "quality_rollback",
                              "model": event.get("model", "")})

    def quality_ring(self) -> List[Dict[str, Any]]:
        """A copy of the quality ring — the Perfetto exporter's
        ``quality`` track source (obs/export.py quality_events)."""
        with self._lock:
            return list(self._quality)

    def mark(self, label: str, **data: Any) -> None:
        """Append a caller-defined waypoint (heartbeat seq, round index)
        to the mark ring — breadcrumbs for the dump reader."""
        with self._lock:
            self._marks.append(
                {"label": label, "unix": round(time.time(), 6),
                 **_json_safe_detail(data)}
            )
        self._m_records.inc(kind="mark")

    def observe_metrics(self) -> bool:
        """Snapshot the metrics registry into the bounded snapshot ring,
        rate-limited to one per ``metrics_interval_s`` (worker heartbeat
        loops call this every beat; most beats are a no-op)."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_metrics_at < self.metrics_interval_s:
                return False
            self._last_metrics_at = now
        snapshot = {"unix": round(time.time(), 6),
                    "metrics": get_registry().snapshot()}
        with self._lock:
            self._metric_ring.append(snapshot)
        self._m_records.inc(kind="metrics")
        return True

    # ------------------------------------------------------------------ dump
    def dump(
        self,
        trigger: str,
        detail: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Write the post-mortem artifact for ``trigger``; returns its
        path, or None when rate-limited. Never raises — a flight-recorder
        bug must not take down the process it exists to explain."""
        try:
            return self._dump(trigger, detail, force)
        except Exception:
            return None

    def _dump(
        self, trigger: str, detail: Optional[Dict[str, Any]], force: bool
    ) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_at.get(trigger, -float("inf"))
            if not force and now - last < self.min_dump_interval_s:
                return None
            self._last_dump_at[trigger] = now
            ledger = list(self._ledger)
            quality = list(self._quality)
            marks = list(self._marks)
            metric_ring = list(self._metric_ring)
        session = _spans.active_session()
        span_tail: List[Dict[str, Any]] = []
        dropped = 0
        if session is not None:
            from .fleet import span_fragment  # lazy: fleet imports spans too

            span_tail = [
                span_fragment(s, session)
                for s in session.spans()[-self.capacity:]
            ]
            dropped = session.dropped
        # The cost observatory's recent per-node entries: a crash snapshot
        # carries the perf picture (predicted vs measured, roofline
        # placement) alongside the events that explain it.
        from . import cost as _cost

        perf_ledger = [e.to_json() for e in _cost.get_ledger().tail(32)]
        payload = {
            "flightrec": 1,
            "role": self.role,
            "pid": os.getpid(),
            "trigger": trigger,
            "written_unix": round(time.time(), 6),
            "detail": _json_safe_detail(detail or {}),
            "spans": span_tail,
            "ledger": ledger,
            "quality": quality,
            "perf_ledger": perf_ledger,
            "metric_snapshots": metric_ring,
            "metrics": get_registry().snapshot(),
            "marks": marks,
            "dropped_spans": dropped,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"flightrec-{self.role}-{os.getpid()}.json"
        )
        body = json.dumps(payload)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)  # readers never see a torn artifact
        self._m_dumps.inc(trigger=trigger)
        self._m_dump_bytes.set(len(body))
        with self._lock:
            self.dumps.append({"trigger": trigger, "path": path})
        return path


# --------------------------------------------------------- process singleton

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def install_flight_recorder(role: str, **kwargs: Any) -> FlightRecorder:
    """Install the process-wide recorder (idempotent — the first
    installer's role wins; a supervisor and a frontend sharing a process
    share one recorder)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(role, **kwargs)
        return _recorder


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _recorder


def reset_flight_recorder() -> None:
    """Testing hook: drop the installed recorder."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def observe_ledger(kind: str, label: str, detail: Dict[str, Any]) -> None:
    """RecoveryLog.record's hook: one global read when no recorder is
    installed; otherwise ring-append + auto-dump on trigger kinds.
    Exceptions are swallowed — the ledger write must always win."""
    recorder = _recorder
    if recorder is None:
        return
    try:
        recorder.observe_ledger(kind, label, detail)
    except Exception:
        pass
