"""Fleet aggregation: merge per-process telemetry into one trace and one
scrape. A copy of ``keystone_tpu/obs/fleet.py``.

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

- **``trace``** (:func:`trace_from_args`): drive a traffic sweep against a
  real multiworker fleet (the torch-free stub backend by default, card
  workers serving a synthetic pipeline with ``--backend synthetic``,
  optional seeded worker kill) and emit the merged trace + scrape
  artifacts. The merge runs after the fleet stops: each worker ships the
  fragments no heartbeat carried on its exit line, and a worker whose
  exit line never came is named in the trace's ``fragments_missing``.

Imports no torch, like the rest of ``obs/``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
        fragments_missing: Sequence[str] = (),
    ) -> Dict[str, Any]:
        """One Perfetto-loadable Chrome trace over every process: worker
        fragments plus the local session's spans, pid-mapped tracks with
        process_name/thread_name metadata, timestamps normalized to the
        earliest fragment. ``fragments_missing`` names the workers whose
        last fragments never arrived (the supervisor's
        ``fragments_missing()``); the metadata lists them."""
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
                "fragments_missing": sorted(fragments_missing),
            },
        }


def write_fleet_trace(
    collector: FleetTraceCollector,
    path: str,
    local_session: Optional[TraceSession] = None,
    local_role: str = "supervisor",
    fragments_missing: Sequence[str] = (),
) -> str:
    with open(path, "w") as f:
        json.dump(
            collector.merge(
                local_session=local_session, local_role=local_role,
                fragments_missing=fragments_missing,
            ),
            f,
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


# ----------------------------------------------------------------- trace CLI


def add_trace_arguments(parser) -> None:
    """Flags for ``trace`` (plain argparse — the CLI's --help path imports
    no torch, and the default stub backend keeps the whole run
    torch-free)."""
    parser.add_argument(
        "--workers", type=int, default=2, help="worker processes in the fleet"
    )
    parser.add_argument(
        "--requests", type=int, default=64, help="HTTP requests to sweep"
    )
    parser.add_argument(
        "--backend", choices=("stub", "synthetic"), default="stub",
        help="worker backend: the torch-free stub echo (default), or "
             "workers serving a synthetic --dim-wide pipeline on --device",
    )
    parser.add_argument(
        "--dim", type=int, default=64, help="the synthetic pipeline's width",
    )
    parser.add_argument(
        "--device", default=None,
        help="the synthetic workers' torch device (default: the CUDA device; "
             "'cpu' to run on the CPU)",
    )
    parser.add_argument(
        "--stub-delay-ms", type=float, default=0.0,
        help="per-request delay of the stub backend",
    )
    parser.add_argument(
        "--kill-request", type=int, default=0,
        help="SIGKILL worker 0 at its Nth request (0 = no chaos); the "
             "killed worker leaves a flight-recorder dump and its "
             "in-flight work requeues under the same trace id",
    )
    parser.add_argument(
        "--concurrency", type=int, default=4,
        help="parallel HTTP client threads",
    )
    parser.add_argument(
        "--deadline-ms", type=float, default=60000.0,
        help="per-request deadline for the sweep",
    )
    parser.add_argument(
        "--out-dir", default="tracedir",
        help="directory for fleet_trace.json / fleet_metrics.prom / "
             "flightrec-*.json",
    )
    parser.add_argument("--listen", default="127.0.0.1:0")


def trace_from_args(args) -> int:
    """Drive a traffic sweep against a real multiworker fleet under full
    fleet tracing; write the merged Perfetto trace and two /metrics
    scrapes; print one ``TRACE_STATS:`` JSON line."""
    import os
    import queue as queue_mod
    import urllib.request

    from ..reliability.retry import RetryPolicy
    from ..serving.frontend import ServingFrontend, parse_listen
    from ..serving.supervisor import (
        FAULT_SPECS_WORKER_ENV,
        SupervisorConfig,
        WorkerSupervisor,
    )
    from . import spans as _spans
    from .flight import install_flight_recorder

    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    recorder = install_flight_recorder("frontend", out_dir=out_dir)
    session = _spans.install_session("fleet-trace", sync_timings=False)

    synthetic = args.backend == "synthetic"
    d = args.dim if synthetic else 4
    spec: Dict[str, Any] = (
        {"synthetic": {"d": d}} if synthetic else {"stub": {"delay_ms": args.stub_delay_ms}}
    )
    env = {FLEET_TRACE_ENV: "1", "KEYSTONE_FLIGHT_DIR": out_dir}
    if args.kill_request:
        env[FAULT_SPECS_WORKER_ENV + "0"] = json.dumps(
            [{"match": "serving.worker.request", "kind": "kill",
              "calls": [args.kill_request]}]
        )
    supervisor = WorkerSupervisor(
        spec,
        SupervisorConfig(
            workers=args.workers,
            heartbeat_s=0.1,
            hang_timeout_s=10.0,
            ready_timeout_s=240.0,
            queue_depth=args.requests + 64,
            worker_queue_depth=args.requests + 32,
            restart_policy=RetryPolicy(
                max_attempts=4, base_delay_s=0.2, max_delay_s=2.0
            ),
            # The stub ignores the device; card workers take it.
            device=args.device if synthetic else None,
        ),
        env=env,
    ).start()
    host, port = parse_listen(args.listen)
    frontend = None
    errors = 0
    scrapes: List[str] = []
    stats: Dict[str, Any] = {}
    try:
        supervisor.wait_ready()
        frontend = ServingFrontend(
            supervisor, host, port,
            default_deadline_s=args.deadline_ms / 1e3,
        ).start()
        base_url = f"http://{frontend.host}:{frontend.port}"

        def scrape() -> str:
            with urllib.request.urlopen(base_url + "/metrics", timeout=30) as r:
                return r.read().decode()

        work: "queue_mod.Queue" = queue_mod.Queue()
        for i in range(args.requests):
            work.put(i)
        error_lock = threading.Lock()
        error_box = [0]

        def client() -> None:
            while True:
                try:
                    i = work.get_nowait()
                except queue_mod.Empty:
                    return
                body = json.dumps(
                    {"x": [float(i % 7)] * d, "deadline_ms": args.deadline_ms}
                ).encode()
                request = urllib.request.Request(
                    base_url + "/v1/apply", data=body,
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(request, timeout=120) as r:
                        json.loads(r.read())
                except Exception:
                    with error_lock:
                        error_box[0] += 1

        with _spans.span("trace:sweep", requests=args.requests):
            threads = [
                threading.Thread(target=client, name=f"trace-client-{t}")
                for t in range(max(args.concurrency, 1))
            ]
            for t in threads:
                t.start()
            # Mid-sweep scrape: with the after-sweep scrape below it is
            # the monotonic-through-restart evidence.
            time.sleep(0.2)
            scrapes.append(scrape())
            for t in threads:
                t.join()
        errors = error_box[0]
        scrapes.append(scrape())
        stats = supervisor.stats()
    finally:
        if frontend is not None:
            frontend.stop()
        # Stop BEFORE the merge: each worker's exit line carries the
        # fragments no heartbeat shipped, so the merge waits on no beat.
        supervisor.stop(drain=True)
    merged = supervisor.fleet.merge(
        local_session=session, local_role="frontend",
        fragments_missing=supervisor.fragments_missing(),
    )

    trace_path = os.path.join(out_dir, "fleet_trace.json")
    with open(trace_path, "w") as f:
        json.dump(merged, f)
    prom_path = os.path.join(out_dir, "fleet_metrics.prom")
    with open(prom_path, "w") as f:
        f.write(scrapes[-1])

    def fleet_served(text: str) -> float:
        total = 0.0
        for line in text.splitlines():
            if line.startswith(_names.FLEET_REQUESTS + "{"):
                try:
                    total += float(line.rsplit(" ", 1)[1])
                except ValueError:
                    pass
        return total

    span_counts: Dict[str, int] = {}
    span_names: Dict[str, List[str]] = {}
    for event in merged["traceEvents"]:
        if event.get("ph") == "X":
            role = merged["otherData"]["processes"].get(str(event["pid"]), "?")
            span_counts[role] = span_counts.get(role, 0) + 1
            names_seen = span_names.setdefault(role, [])
            if event["name"] not in names_seen:
                names_seen.append(event["name"])
    flight_dumps = sorted(
        name for name in os.listdir(out_dir) if name.startswith("flightrec-")
    )
    summary = {
        "trace_path": trace_path,
        "prom_path": prom_path,
        "backend": args.backend,
        "requests": args.requests,
        "errors": errors,
        "trace_ids": merged["otherData"]["trace_ids"][:8],
        "processes": merged["otherData"]["processes"],
        "fragments_missing": merged["otherData"]["fragments_missing"],
        "span_counts": span_counts,
        "span_names": {role: sorted(names) for role, names in span_names.items()},
        "clock_skew_s": merged["otherData"]["clock_skew_s"],
        "metric_families": scrapes[-1].count("# HELP"),
        "fleet_served_mid": fleet_served(scrapes[0]),
        "fleet_served_final": fleet_served(scrapes[-1]),
        "requeued": stats["supervisor"]["requeued"],
        "restarts": stats["supervisor"]["restarts"],
        "flight_dumps": flight_dumps,
        "local_flight_dumps": [d["trigger"] for d in recorder.dumps],
    }
    print("TRACE_STATS:" + json.dumps(summary))
    return 0
