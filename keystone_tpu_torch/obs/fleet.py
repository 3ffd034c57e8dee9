"""Fleet aggregation: merge per-process telemetry into one trace and one
scrape. A copy of ``keystone_tpu/obs/fleet.py`` without its ``trace``
command (ROADMAP item 13b).

The multi-worker runtime is a fleet of processes — HTTP frontend +
supervisor in one, N workers — each with its own
:class:`~keystone_tpu_torch.obs.spans.TraceSession` and metrics registry.
This module is the plane that makes them one system:

- **Span fragments** (:func:`span_fragment`): a span serialized with
  *absolute unix* timestamps (``session.started_unix`` anchors the
  perf_counter offsets), so fragments from different processes merge
  without exchanging clock bases — processes on one host share the wall
  clock, and the residual skew estimate from the heartbeat handshake is
  published as ``keystone_fleet_clock_skew_seconds``.
- **FleetTraceCollector**: the supervisor-side sink. Workers ship
  fragments + metric-registry deltas on the existing heartbeat channel
  (bounded per beat); the collector files them per (role, pid), folds
  metric deltas monotonically across worker *incarnations* (a restarted
  worker's counters restart from zero; the fleet's must not), and
  :meth:`merge`\\ s everything — worker fragments plus the local
  session — into one Perfetto-loadable Chrome trace with per-process
  tracks.
- **Fleet Prometheus** (:func:`fleet_prometheus_text`): the frontend's
  ``GET /metrics`` body — the local registry (the supervisor's own
  ``keystone_serving_*`` series live here) plus ``keystone_fleet_*``
  counters published from the supervisor's restart-safe high-water
  aggregation.

Imports no torch, like the rest of ``obs/``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import names as _names
from .export import _json_safe, prometheus_text
from .metrics import get_registry
from .spans import Span, TraceSession

#: env flag: workers (and the serve front-end) install a process-lifetime
#: span session and ship fragments on heartbeats when set.
FLEET_TRACE_ENV = "KEYSTONE_FLEET_TRACE"

#: fragments shipped per heartbeat at most — one beat must stay one
#: cheap line; a burst drains over the next beats.
FRAGMENTS_PER_BEAT = 128

#: per-process fragment retention in the collector (drop-oldest).
MAX_FRAGMENTS_PER_PROCESS = 20_000

#: worker counters aggregated monotonically across incarnations
#: (supervisor high-water marks).
MONOTONIC_WORKER_COUNTERS = (
    "served", "batches", "sheds", "timeouts", "retries", "failures",
)


# ------------------------------------------------------------ span fragments


def span_fragment(span: Span, session: TraceSession) -> Dict[str, Any]:
    """One span as a compact wire fragment with ABSOLUTE unix times —
    ``a``/``b`` are start/end seconds since the epoch, so fragments from
    any process merge on a shared axis. Keys are short on purpose: these
    ride heartbeat lines."""
    origin = session.started_unix - session.started_s
    end = span.end_s if span.end_s is not None else span.start_s
    fragment: Dict[str, Any] = {
        "n": span.name,
        "t": span.trace_id,
        "s": span.span_id,
        "a": round(origin + span.start_s, 6),
        "b": round(origin + end, 6),
        "tid": span.thread_id or 0,
        "tn": span.thread_name,
    }
    if span.parent_id:
        fragment["p"] = span.parent_id
    if span.status != "ok":
        fragment["st"] = span.status
    if span.attributes:
        fragment["at"] = {
            k: _json_safe(v) for k, v in span.attributes.items()
        }
    return fragment


def drain_fragments(
    session: TraceSession, cursor: int, limit: int = FRAGMENTS_PER_BEAT
) -> Tuple[List[Dict[str, Any]], int]:
    """Fragments for the session's spans past ``cursor`` (bounded by
    ``limit``), plus the advanced cursor. ``cursor`` is an ABSOLUTE
    accepted-span index (``TraceSession.added``), so it stays a stable
    ship-once iterator even for ring sessions: spans evicted before
    they could ship are skipped (the ring outran the heartbeat), never
    re-shipped or double-shipped."""
    buffer, total = session.tail()
    base = total - len(buffer)  # absolute index of buffer[0]
    start = max(cursor, base)
    fresh = buffer[start - base:start - base + limit]
    return [span_fragment(s, session) for s in fresh], start + len(fresh)


# ---------------------------------------------------------------- collector


class FleetTraceCollector:
    """Supervisor-side sink for worker span fragments, clock anchors,
    and metric-registry deltas."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fragments: Dict[Tuple[str, int], List[Dict[str, Any]]] = {}
        self._fragment_drops = 0
        self._clocks: Dict[Tuple[str, int], Dict[str, float]] = {}
        #: worker_id → (incarnation, live cumulative series values)
        self._metric_live: Dict[str, Tuple[int, Dict[str, float]]] = {}
        #: worker_id → folded totals from dead incarnations
        self._metric_base: Dict[str, Dict[str, float]] = {}
        self._m_fragments = _names.metric(_names.FLEET_SPAN_FRAGMENTS)
        self._m_bytes = _names.metric(_names.FLEET_TRACE_BYTES)
        self._m_skew = _names.metric(_names.FLEET_CLOCK_SKEW)

    # ------------------------------------------------------------- ingestion
    def add_fragments(
        self,
        role: str,
        pid: int,
        fragments: List[Dict[str, Any]],
        raw_bytes: Optional[int] = None,
    ) -> None:
        """File one shipment of fragments. ``raw_bytes`` is the wire
        size the caller already knows (the heartbeat line length —
        supervisor reader threads must not re-serialize every fragment
        just to count bytes); without it, fall back to measuring."""
        if not fragments:
            return
        if raw_bytes is None:
            raw_bytes = sum(len(json.dumps(f)) for f in fragments)
        with self._lock:
            bucket = self._fragments.setdefault((role, int(pid or 0)), [])
            bucket.extend(fragments)
            overflow = len(bucket) - MAX_FRAGMENTS_PER_PROCESS
            if overflow > 0:
                del bucket[:overflow]
                self._fragment_drops += overflow
        self._m_fragments.inc(len(fragments), role=role)
        self._m_bytes.inc(raw_bytes)

    def observe_clock(
        self, role: str, pid: int, clock: Dict[str, Any]
    ) -> None:
        """Heartbeat/ready handshake: the shipper's wall+perf anchors at
        emit time. ``time.time() - unix`` at receipt bounds skew from
        above by the pipe latency — on one host that residual IS the
        alignment error of the merged trace."""
        unix = clock.get("unix")
        if not isinstance(unix, (int, float)):
            return
        skew = time.time() - float(unix)
        with self._lock:
            self._clocks[(role, int(pid or 0))] = {
                "unix": float(unix),
                "perf": float(clock.get("perf") or 0.0),
                "received_unix": time.time(),
                "skew_s": round(skew, 6),
            }
        self._m_skew.set(round(skew, 6), role=role)

    def observe_metrics(
        self, worker_id: str, incarnation: int, delta: Dict[str, Any]
    ) -> None:
        """Fold one heartbeat's metric-registry delta. Deltas accumulate
        per (worker, incarnation); a new incarnation folds the previous
        one's cumulative values into the worker's base, so
        :meth:`metric_totals` stays monotonic through restarts."""
        with self._lock:
            live_incarnation, live = self._metric_live.get(
                worker_id, (None, {})
            )
            if live_incarnation != incarnation:
                base = self._metric_base.setdefault(worker_id, {})
                for key, value in live.items():
                    base[key] = base.get(key, 0.0) + value
                live = {}
            for key, value in delta.items():
                if isinstance(value, (int, float)):
                    live[key] = live.get(key, 0.0) + float(value)
            self._metric_live[worker_id] = (incarnation, live)

    # ----------------------------------------------------------------- views
    def fragments(self) -> Dict[Tuple[str, int], List[Dict[str, Any]]]:
        with self._lock:
            return {k: list(v) for k, v in self._fragments.items()}

    def clocks(self) -> Dict[Tuple[str, int], Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._clocks.items()}

    def metric_totals(self) -> Dict[str, float]:
        """Fleet-cumulative series values: sum over workers of folded
        base + live incarnation. Monotonic by construction."""
        out: Dict[str, float] = {}
        with self._lock:
            for worker_id, (_, live) in self._metric_live.items():
                for key, value in live.items():
                    out[key] = out.get(key, 0.0) + value
            for base in self._metric_base.values():
                for key, value in base.items():
                    out[key] = out.get(key, 0.0) + value
        return out

    # ----------------------------------------------------------------- merge
    def merge(
        self,
        local_session: Optional[TraceSession] = None,
        local_role: str = "supervisor",
    ) -> Dict[str, Any]:
        """One Perfetto-loadable Chrome trace over every process: worker
        fragments plus the local session's spans, pid-mapped tracks with
        process_name/thread_name metadata, timestamps normalized to the
        earliest fragment."""
        import os

        per_process = self.fragments()
        if local_session is not None:
            local = [
                span_fragment(s, local_session)
                for s in local_session.spans()
            ]
            key = (local_role, os.getpid())
            per_process[key] = per_process.get(key, []) + local

        starts = [
            f["a"] for frags in per_process.values() for f in frags
        ]
        t0 = min(starts) if starts else 0.0
        events: List[Dict[str, Any]] = []
        processes: Dict[int, str] = {}
        trace_ids: set = set()
        threads_seen: Dict[Tuple[int, int], str] = {}
        for (role, pid), frags in sorted(per_process.items()):
            processes[pid] = role
            for f in frags:
                trace_ids.add(f["t"])
                tid = int(f.get("tid") or 0)
                if (pid, tid) not in threads_seen:
                    threads_seen[(pid, tid)] = f.get("tn") or f"thread-{tid}"
                args: Dict[str, Any] = dict(f.get("at") or {})
                args["trace_id"] = f["t"]
                args["span_id"] = f["s"]
                if f.get("p"):
                    args["parent_id"] = f["p"]
                if f.get("st"):
                    args["status"] = f["st"]
                events.append(
                    {
                        "name": f["n"],
                        "cat": f["n"].split(":", 1)[0] or "span",
                        "ph": "X",
                        "ts": round((f["a"] - t0) * 1e6, 3),
                        "dur": round(max(f["b"] - f["a"], 0.0) * 1e6, 3),
                        "pid": pid,
                        "tid": tid,
                        "args": args,
                    }
                )
        for pid, role in processes.items():
            events.append(
                {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": role}}
            )
        for (pid, tid), name in threads_seen.items():
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": name}}
            )
        clock_skews = {
            f"{role}:{pid}": anchors.get("skew_s")
            for (role, pid), anchors in self.clocks().items()
        }
        with self._lock:
            dropped = self._fragment_drops
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_ids": sorted(trace_ids),
                "processes": {str(pid): role for pid, role in processes.items()},
                "base_unix": t0,
                "clock_skew_s": clock_skews,
                "dropped_fragments": dropped,
            },
        }


def write_fleet_trace(
    collector: FleetTraceCollector,
    path: str,
    local_session: Optional[TraceSession] = None,
    local_role: str = "supervisor",
) -> str:
    with open(path, "w") as f:
        json.dump(
            collector.merge(local_session=local_session, local_role=local_role), f
        )
    return path


# ------------------------------------------------------------- /metrics body


# Serializes the read-compare-raise below: two concurrent /metrics
# scrapes racing it would BOTH inc by (target - current) and inflate
# the counter forever (each metric's own lock only makes value() and
# inc() individually atomic, not the pair).
_publish_lock = threading.Lock()


def publish_fleet_metrics(supervisor: Any) -> None:
    """Fold the supervisor's restart-safe per-worker counter totals into
    the ``keystone_fleet_*`` registry series. Counter-safe: each series
    is raised to its new high-water value by a non-negative increment,
    so the exposition stays monotonic through worker restarts."""
    totals = supervisor.fleet_counter_totals()
    m_requests = _names.metric(_names.FLEET_REQUESTS)
    m_failures = _names.metric(_names.FLEET_FAILURES)
    with _publish_lock:
        for worker_id, counters in totals.items():
            for metric_obj, key in (
                (m_requests, "served"), (m_failures, "failures")
            ):
                target = float(counters.get(key, 0.0) or 0.0)
                current = metric_obj.value(worker=worker_id)
                if target > current:
                    metric_obj.inc(target - current, worker=worker_id)
    # The heartbeat-shipped metric-registry deltas, folded monotonically
    # per incarnation by the collector, surface as one gauge family
    # keyed by the worker-side series name — the worker processes' OWN
    # counters (their in-process servers' retries, bucket hits, ...)
    # are otherwise invisible to a frontend scrape.
    collector = getattr(supervisor, "fleet", None)
    if collector is not None:
        gauge = _names.metric(_names.FLEET_WORKER_SERIES)
        for series, value in collector.metric_totals().items():
            gauge.set(round(value, 6), series=series)
    # Quality plane: the supervisor's fleet-merged sketch/stream state
    # surfaces as keystone_quality_* gauges on the same scrape.
    quality = getattr(supervisor, "quality", None)
    if quality is not None:
        quality.publish_metrics()


def fleet_prometheus_text(supervisor: Any) -> str:
    """The frontend's ``GET /metrics`` body: the full local registry
    (pre-registered so the schema exports completely) plus the fleet
    counters above."""
    _names.register_all()
    if supervisor is not None and hasattr(supervisor, "fleet_counter_totals"):
        publish_fleet_metrics(supervisor)
    return prometheus_text(get_registry())
