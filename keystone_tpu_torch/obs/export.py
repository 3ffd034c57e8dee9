"""Exporters: Chrome trace-event JSON (Perfetto-loadable), Prometheus
text exposition, and a human-readable span report.

Port of ``keystone_tpu/obs/export.py``; it imports no torch. The fleet
plane (:mod:`.fleet`) reads the Prometheus text and the JSON-safe span
attributes; ``python -m keystone_tpu_torch profile`` writes the Chrome
trace of one session (with the streaming engine's per-chunk slices, the
cost observatory's ledger track and the quality plane's track).

Chrome format: one complete event (``"ph": "X"``) per span with
microsecond ``ts``/``dur`` relative to the session start, one instant
event (``"ph": "i"``) per span event, plus thread-name metadata events so
Perfetto's track labels read "keystone-serving-worker" instead of a bare
tid. Span ids/parent ids ride in ``args``.

Prometheus format follows the text exposition rules: ``# HELP`` /
``# TYPE`` headers for every registered metric (including zero-series
ones — an exported schema with no samples is itself information),
histograms as cumulative ``_bucket{le=...}`` plus ``_sum``/``_count``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .spans import Span, TraceSession


# ------------------------------------------------------------- chrome trace


def _json_safe(value: Any) -> Any:
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


# Synthetic track ids for the streaming engine's per-chunk slices: the
# upload and compute frontiers are pipeline stages, not threads, so they
# get their own named Perfetto tracks next to the real span threads.
_STREAM_UPLOAD_TID = 900001
_STREAM_COMPUTE_TID = 900002

# Synthetic track for the cost observatory's per-node counters.
_COST_LEDGER_TID = 900003

# Synthetic track for the quality plane's drift/gate event stream.
_QUALITY_TID = 900004


def quality_events(
    entries: Any, base_unix: float, pid: int
) -> List[Dict[str, Any]]:
    """Quality-plane ring entries (obs/flight.py ``quality`` ring) as a
    Chrome ``quality`` track: drift scores and gate likelihood ratios as
    ``ph:C`` counter samples, plus one instant event per drift firing /
    gate decision so the moment a model went bad is findable next to the
    serving spans. Ring entries carry ``unix`` stamps; ``base_unix`` is
    the session's wall-clock origin (``TraceSession.started_unix``)."""
    events: List[Dict[str, Any]] = []
    for entry in entries or []:
        ts = round((float(entry.get("unix", base_unix)) - base_unix) * 1e6, 3)
        kind = entry.get("kind")
        counters: Dict[str, Any] = {}
        if kind == "drift" and entry.get("score") is not None:
            counters["drift_score"] = round(float(entry["score"]), 4)
        elif kind == "gate_decision" and entry.get("lr") is not None:
            counters["gate_lr"] = round(float(entry["lr"]), 4)
        if counters:
            events.append(
                {
                    "name": "quality",
                    "cat": "quality",
                    "ph": "C",
                    "ts": ts,
                    "pid": pid,
                    "tid": _QUALITY_TID,
                    "args": counters,
                }
            )
        label = kind or "quality"
        if kind == "gate_decision":
            label = "gate:%s" % entry.get("decision", "?")
        elif kind == "drift":
            label = "drift:%s" % entry.get("model", "?")
        events.append(
            {
                "name": label,
                "cat": "quality",
                "ph": "i",
                "s": "t",
                "ts": ts,
                "pid": pid,
                "tid": _QUALITY_TID,
                "args": {k: _json_safe(v) for k, v in entry.items()},
            }
        )
    if events:
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid,
             "tid": _QUALITY_TID, "args": {"name": "quality"}}
        )
    return events


def cost_ledger_events(
    entries: Any, base_s: float, pid: int
) -> List[Dict[str, Any]]:
    """Perf-ledger entries (obs/cost.py) as Chrome ``ph:C`` counter
    events on a ``cost-ledger`` track: achieved GFLOP/s, GB/s, and
    measured-vs-predicted ratio sampled at each node's finalize time —
    roofline placement over the session timeline, next to the node spans
    that produced it. ``base_s`` is the session's perf_counter origin
    (entries carry their own ``t_s`` anchor)."""
    events: List[Dict[str, Any]] = []
    for entry in entries or []:
        ts = round((getattr(entry, "t_s", 0.0) - base_s) * 1e6, 3)
        args: Dict[str, Any] = {}
        if getattr(entry, "flops_per_s", None):
            args["gflops_per_s"] = round(entry.flops_per_s / 1e9, 4)
        if getattr(entry, "bytes_per_s", None):
            args["gbytes_per_s"] = round(entry.bytes_per_s / 1e9, 4)
        if getattr(entry, "ratio", None) is not None:
            args["measured_vs_predicted"] = round(entry.ratio, 4)
        if not args:
            continue
        events.append(
            {
                "name": "cost-ledger",
                "cat": "cost",
                "ph": "C",
                "ts": ts,
                "pid": pid,
                "tid": _COST_LEDGER_TID,
                "args": args,
            }
        )
    if events:
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid,
             "tid": _COST_LEDGER_TID, "args": {"name": "cost-ledger"}}
        )
    return events


def stream_report_events(
    report: Any, base_s: float, pid: int
) -> List[Dict[str, Any]]:
    """The last streaming fit's per-chunk event log as Chrome ``ph:X``
    slices: one ``chunk i upload`` slice (upload issued → dispatch) on a
    ``stream-upload`` track and one ``chunk i compute`` slice (dispatch →
    compute observed done) on ``stream-compute`` — so the double-buffer
    overlap (``StreamReport.overlap_ok``) is visually inspectable in
    Perfetto alongside node spans. ``base_s`` is the session's
    perf_counter origin; the report's timestamps are offsets from its own
    ``t0_s`` anchor."""
    events: List[Dict[str, Any]] = []
    if report is None or not getattr(report, "dispatch_t", None):
        return events
    origin = (getattr(report, "t0_s", 0.0) or 0.0) - base_s

    def slice_event(name: str, tid: int, start: float, end: float, **args):
        events.append(
            {
                "name": name,
                "cat": "stream",
                "ph": "X",
                "ts": round((origin + start) * 1e6, 3),
                "dur": round(max(end - start, 0.0) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )

    uploads = report.upload_issued_t
    dispatches = report.dispatch_t
    done = report.compute_done_t
    for i, t_disp in enumerate(dispatches):
        if i < len(uploads):
            slice_event(
                f"chunk {i} upload", _STREAM_UPLOAD_TID, uploads[i], t_disp,
                chunk=i, chunk_rows=report.chunk_rows,
            )
        if i < len(done):
            slice_event(
                f"chunk {i} compute", _STREAM_COMPUTE_TID, t_disp, done[i],
                chunk=i,
            )
    for tid, name in (
        (_STREAM_UPLOAD_TID, "stream-upload"),
        (_STREAM_COMPUTE_TID, "stream-compute"),
    ):
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}}
        )
    return events


def chrome_trace(
    session: TraceSession,
    stream_report: Any = None,
    cost_ledger: Any = None,
    quality_ring: Any = None,
) -> Dict[str, Any]:
    """The session's spans as a Chrome trace-event JSON object; pass the
    last :class:`~keystone_tpu_torch.workflow.streaming.StreamReport` to also
    emit its per-chunk upload/compute slices (:func:`stream_report_events`),
    a list of perf-ledger entries (``obs.cost.get_ledger().tail(n)``)
    for the ``cost-ledger`` counter track (:func:`cost_ledger_events`),
    and the flight recorder's quality ring
    (``get_flight_recorder().quality_ring()``) for the ``quality``
    drift/gate track (:func:`quality_events`)."""
    import os

    pid = os.getpid()
    base = session.started_s
    events: List[Dict[str, Any]] = []
    seen_threads: Dict[int, str] = {}
    for span in session.spans():
        tid = span.thread_id or 0
        if tid not in seen_threads:
            seen_threads[tid] = span.thread_name
        end = span.end_s if span.end_s is not None else span.start_s
        args = {k: _json_safe(v) for k, v in span.attributes.items()}
        args["span_id"] = span.span_id
        if span.parent_id:
            args["parent_id"] = span.parent_id
        args["trace_id"] = span.trace_id
        if span.status != "ok":
            args["status"] = span.status
        events.append(
            {
                "name": span.name,
                "cat": span.name.split(":", 1)[0] or "span",
                "ph": "X",
                "ts": round((span.start_s - base) * 1e6, 3),
                "dur": round((end - span.start_s) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
        for event in span.events:
            events.append(
                {
                    "name": event.name,
                    "cat": "event",
                    "ph": "i",
                    "s": "t",  # thread-scoped instant
                    "ts": round((event.ts_s - base) * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                    "args": {k: _json_safe(v) for k, v in event.attributes.items()},
                }
            )
    for tid, thread_name in seen_threads.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": thread_name or f"thread-{tid}"},
            }
        )
    events.extend(stream_report_events(stream_report, session.started_s, pid))
    events.extend(cost_ledger_events(cost_ledger, session.started_s, pid))
    events.extend(quality_events(quality_ring, session.started_unix, pid))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": session.trace_id,
            "session": session.name,
            "started_unix": session.started_unix,
            "dropped_spans": session.dropped,
        },
    }


def write_chrome_trace(
    session: TraceSession,
    path: str,
    stream_report: Any = None,
    cost_ledger: Any = None,
    quality_ring: Any = None,
) -> str:
    with open(path, "w") as f:
        json.dump(
            chrome_trace(
                session, stream_report=stream_report, cost_ledger=cost_ledger,
                quality_ring=quality_ring,
            ),
            f,
        )
    return path


# -------------------------------------------------------------- prometheus


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(key, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition of every registered metric."""
    registry = registry or get_registry()
    lines: List[str] = []
    for metric in registry.collect():
        lines.append(f"# HELP {metric.name} {metric.help or metric.name}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        series = metric.series()
        if isinstance(metric, Histogram):
            for key, s in sorted(series.items()):
                cumulative = 0
                for bound, count in zip(metric.buckets, s.bucket_counts):
                    cumulative += count
                    le = 'le="%r"' % (bound,)
                    lines.append(
                        f"{metric.name}_bucket{_fmt_labels(key, le)} {cumulative}"
                    )
                cumulative += s.bucket_counts[-1]
                inf = 'le="+Inf"'
                lines.append(
                    f"{metric.name}_bucket{_fmt_labels(key, inf)} {cumulative}"
                )
                lines.append(f"{metric.name}_sum{_fmt_labels(key)} {repr(float(s.sum))}")
                lines.append(f"{metric.name}_count{_fmt_labels(key)} {s.count}")
        elif isinstance(metric, (Counter, Gauge)):
            if not series and not metric.label_names:
                lines.append(f"{metric.name} 0")
            for key, value in sorted(series.items()):
                lines.append(f"{metric.name}{_fmt_labels(key)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry: Optional[MetricsRegistry] = None) -> str:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path


# ------------------------------------------------------------ human report


def report(session: TraceSession, max_depth: int = 6) -> str:
    """Indented span tree, children in start order, slowest roots first."""
    spans = session.spans()
    children: Dict[Optional[str], List[Span]] = {}
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        parent = s.parent_id if s.parent_id in by_id else None
        children.setdefault(parent, []).append(s)
    for siblings in children.values():
        siblings.sort(key=lambda s: s.start_s)
    roots = sorted(children.get(None, []), key=lambda s: -s.duration_s)

    width = max(
        [len("span")] + [min(len(s.name), 48) + 2 * max_depth for s in spans]
    )
    lines = [f"{'span':<{width}}  {'ms':>10}  {'self ms':>10}"]

    def walk(span: Span, depth: int) -> None:
        kids = children.get(span.span_id, [])
        child_s = sum(k.duration_s for k in kids)
        label = ("  " * depth) + span.name[:48]
        flag = " !" if span.status != "ok" else ""
        lines.append(
            f"{label:<{width}}  {span.duration_s * 1e3:>10.3f}  "
            f"{max(span.duration_s - child_s, 0.0) * 1e3:>10.3f}{flag}"
        )
        if depth + 1 < max_depth:
            for kid in kids:
                walk(kid, depth + 1)

    for root in roots:
        walk(root, 0)
    if session.dropped:
        lines.append(f"... {session.dropped} spans dropped (session cap)")
    return "\n".join(lines)
