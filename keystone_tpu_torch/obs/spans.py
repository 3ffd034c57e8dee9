"""Hierarchical spans: the trace substrate the serving layer reports into.

A copy of ``keystone_tpu/obs/spans.py``.

One :class:`TraceSession` collects the spans of one instrumented run.
Spans nest through a per-thread stack — ``span("fit")`` inside
``span("pipeline")`` parents automatically — and cross *threads* through
explicit context handoff: a serving request captures
:func:`current_context` at submit time and the worker thread re-parents
its batch/request spans under it via :func:`attach`, so a request's
trace id survives submit → batch assembly → apply. Across *processes*
the context rides the serving control pipe in its wire form
(:func:`to_wire` / :func:`from_wire`), and a serving worker holds a
process-lifetime ring session (:func:`install_session`) whose spans ship
to the supervisor on heartbeats.

Inactive is free: with no session installed, ``span()`` yields a shared
no-op without allocating a record, and ``add_span_event`` is a single
global read, so instrumentation can stay in hot paths permanently.

Spans use ``time.perf_counter`` timestamps; the session records a
wall-clock anchor so exporters can emit absolute times.

With device annotations on (``obs/device.py::annotations_enabled``) a
span opened under a session is also a ``torch.profiler.record_function``
range named ``keystone/<span name>`` (plus an NVTX range on a card) for
its lifetime, so every span lands on a profiler's timeline, on the
device trace's clock. The range never waits for the device.

When a :func:`tracing_session` closes, a :class:`SessionSummary` of it
(seconds and count by span name, and the registry's series that moved
while it was open) joins a bounded ring, :func:`recent_sessions`: what
the last runs of this process spent and counted, readable after the
session object is gone.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import device as _device
from .metrics import delta, get_registry

TraceContext = Tuple[str, str]  # (trace_id, span_id)

#: JSON field name the serving control pipe carries a wire context under
#: (supervisor → worker request lines).
WIRE_FIELD = "trace"

# Span-id generator: seeded from the system entropy pool once, then a
# single C-level getrandbits per id (~0.5µs). uuid4 here cost ~17µs per
# span (an os.urandom syscall each) — at serving dispatch rates that
# alone blew the 5% tracing-overhead budget.
_id_rng = random.Random()


def _new_id() -> str:
    return "%016x" % _id_rng.getrandbits(64)


def to_wire(context: Optional[TraceContext]) -> Optional[str]:
    """Compact wire form of a trace context — ``"<trace_id>:<span_id>"``
    — for JSON-lines control messages. None stays None (tracing off adds
    zero bytes to the pipe)."""
    if context is None:
        return None
    return f"{context[0]}:{context[1]}"


def from_wire(value: Any) -> Optional[TraceContext]:
    """Parse a wire context; tolerant of garbage (a malformed trace field
    must never fail a request — it just drops the trace link)."""
    if not isinstance(value, str) or ":" not in value:
        return None
    trace_id, _, span_id = value.partition(":")
    if not trace_id:
        return None
    return (trace_id, span_id)


@dataclass(slots=True)
class SpanEvent:
    name: str
    ts_s: float  # perf_counter timestamp
    attributes: Dict[str, Any] = field(default_factory=dict)


@dataclass(slots=True)
class Span:
    """One finished (or in-flight) timed operation."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float
    end_s: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[SpanEvent] = field(default_factory=list)
    status: str = "ok"
    thread_id: int = 0
    thread_name: str = ""

    @property
    def duration_s(self) -> float:
        return (self.end_s if self.end_s is not None else self.start_s) - self.start_s

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes: Any) -> None:
        self.events.append(SpanEvent(name, time.perf_counter(), dict(attributes)))

    def context(self) -> TraceContext:
        return (self.trace_id, self.span_id)


class _NoopSpan:
    """Shared do-nothing span yielded when no session is active."""

    __slots__ = ()
    name = ""
    span_id = ""
    trace_id = ""

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attributes: Any) -> None:
        pass

    def context(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class TraceSession:
    """Bounded collector of the spans of one instrumented run.

    ``sync_timings`` declares whether this session needs real per-node
    device timings: when True (profiling sessions), the executor waits
    for the device per node, so a node span's duration is the node's
    work; when False, node spans record dispatch time only (sessions that
    exist for counters and coarse spans, such as a serving worker's).

    ``ring`` selects what the cap sacrifices: False (bounded profiling
    runs) drops NEW spans past ``max_spans`` (``dropped`` counts them), so
    a runaway run can't evict the phases already captured; True
    (process-lifetime sessions: serving workers, fleet tracing) evicts
    the OLDEST (``evicted`` counts them), so the buffer always holds the
    most recent window. ``added`` counts every accepted span, so ring
    consumers (``fleet.drain_fragments``) can cursor by absolute index
    across evictions.
    """

    def __init__(
        self,
        name: str = "trace",
        max_spans: int = 100_000,
        sync_timings: bool = True,
        ring: bool = False,
    ):
        self.name = name
        self.sync_timings = sync_timings
        self.trace_id = _new_id()
        self.started_unix = time.time()
        self.started_s = time.perf_counter()
        self.max_spans = max_spans
        self.ring = ring
        self.dropped = 0
        self.evicted = 0
        self.added = 0
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                if not self.ring:
                    self.dropped += 1
                    return
                self._spans.popleft()
                self.evicted += 1
            self._spans.append(span)
            self.added += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def tail(self) -> Tuple[List[Span], int]:
        """(current buffer, total spans ever accepted): the absolute
        index of ``buffer[0]`` is ``total - len(buffer)``, the datum
        ring-aware cursors (fleet shipping) advance against."""
        with self._lock:
            return list(self._spans), self.added

    def find(self, name_prefix: str) -> List[Span]:
        return [s for s in self.spans() if s.name.startswith(name_prefix)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def summary(self, counters: Optional[Dict[str, float]] = None) -> "SessionSummary":
        """Seconds and count by span name of the finished spans (spans of
        one name add up, nested or not)."""
        count: Dict[str, int] = {}
        seconds: Dict[str, float] = {}
        for record in self.spans():
            count[record.name] = count.get(record.name, 0) + 1
            seconds[record.name] = seconds.get(record.name, 0.0) + record.duration_s
        return SessionSummary(self.name, count, seconds, dict(counters or {}))


@dataclass
class SessionSummary:
    """What one closed :func:`tracing_session` spent and counted."""

    name: str
    #: Finished spans by name.
    span_count: Dict[str, int]
    #: Their summed seconds by name.
    span_seconds: Dict[str, float]
    #: Registry series that moved while the session was open
    #: (``name{label=value}`` → change, as ``metrics.delta`` gives it).
    counters: Dict[str, float]


#: How many closed sessions :func:`recent_sessions` keeps.
RECENT_SESSIONS = 256
_recent: "deque[SessionSummary]" = deque(maxlen=RECENT_SESSIONS)


def recent_sessions() -> List[SessionSummary]:
    """Summaries of the last :data:`RECENT_SESSIONS` sessions that
    :func:`tracing_session` closed in this process, oldest first."""
    with _session_lock:
        return list(_recent)


# ------------------------------------------------------------ active state

_session: Optional[TraceSession] = None
_session_lock = threading.Lock()
_state = threading.local()  # .stack: List[Span], .attached: TraceContext


def active_session() -> Optional[TraceSession]:
    return _session


def _stack() -> List[Span]:
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = []
        _state.stack = stack
    return stack


@contextmanager
def tracing_session(
    name: str = "trace", max_spans: int = 100_000, sync_timings: bool = True
) -> Iterator[TraceSession]:
    """Install a process-wide :class:`TraceSession`. Nested calls reuse the
    outer session (the yielded object is the ACTIVE session, which is what
    exporters should read — including its ``sync_timings`` choice)."""
    global _session
    with _session_lock:
        if _session is not None:
            outer = _session
            nested = True
        else:
            outer = TraceSession(name, max_spans=max_spans, sync_timings=sync_timings)
            _session = outer
            nested = False
    before = None if nested else get_registry().snapshot()
    try:
        yield outer
    finally:
        if not nested:
            with _session_lock:
                _session = None
            summary = outer.summary(delta(get_registry().snapshot(), before))
            with _session_lock:
                _recent.append(summary)


def install_session(
    name: str = "trace",
    max_spans: int = 100_000,
    sync_timings: bool = True,
    ring: bool = True,
) -> TraceSession:
    """Install a process-LIFETIME session (no context manager: worker
    processes and long-lived daemons own the process scope; fleet tracing
    ships its recent spans on heartbeats). Ring semantics by default: a
    long-lived process keeps its most RECENT spans, so shipping never
    goes dark once the buffer is full. Idempotent: an existing session is
    reused, like a nested :func:`tracing_session`."""
    global _session
    with _session_lock:
        if _session is None:
            _session = TraceSession(name, max_spans=max_spans, sync_timings=sync_timings, ring=ring)
        return _session


class _NoopSpanContext:
    """Shared no-op ``with`` target when no session is active."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN_CM = _NoopSpanContext()


class _SpanContext:
    """Slotted context manager for one open span. Hand-rolled instead of
    ``@contextmanager``: the generator protocol costs several µs per
    span, and span() sits on the serving dispatch hot path."""

    __slots__ = ("_record", "_stack", "_session", "_mirror", "_range")

    def __init__(self, record: Span, stack: List[Span], session: TraceSession, mirror: bool):
        self._record = record
        self._stack = stack
        self._session = session
        self._mirror = mirror
        self._range = None

    def __enter__(self) -> Span:
        # Side effects happen HERE, not at span() call time: a
        # constructed-but-never-entered context manager must not leave a
        # phantom record on the thread's stack (it would corrupt every
        # later span's parentage and unbalance __exit__'s pop).
        record = self._record
        if self._mirror:
            self._range = _open_range("keystone/" + record.name)
        self._stack.append(record)
        record.start_s = time.perf_counter()
        return record

    def __exit__(self, exc_type, exc, tb) -> bool:
        record = self._record
        if exc_type is not None:
            record.status = "error"
            record.add_event(
                "exception", type=exc_type.__name__, message=str(exc)[:200]
            )
        record.end_s = time.perf_counter()
        self._stack.pop()
        self._session.add(record)
        if self._range is not None:
            _close_range(self._range)
        return False  # always re-raise


def _open_range(name: str):
    """A profiler range (and, on a card, an NVTX range) named ``name``,
    open until :func:`_close_range`. Host calls only: nothing waits for
    the device."""
    import torch

    profiler_range = torch.profiler.record_function(name)
    profiler_range.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    return profiler_range, nvtx


def _close_range(opened) -> None:
    import torch

    profiler_range, nvtx = opened
    if nvtx:
        torch.cuda.nvtx.range_pop()
    profiler_range.__exit__(None, None, None)


def _thread_info() -> Tuple[int, str]:
    """(ident, name) of the current thread, cached thread-locally —
    ``threading.current_thread()`` costs ~0.5µs per call on the dispatch
    hot path and a thread's identity never changes."""
    info = getattr(_state, "thread_info", None)
    if info is None:
        thread = threading.current_thread()
        info = (thread.ident or 0, thread.name)
        _state.thread_info = info
    return info


def span(name: str, parent: Optional[TraceContext] = None, **attributes: Any):
    """Open a child span of the current thread's active span (or of the
    attached remote context, or a session root). No-op without a session;
    with device annotations on, also a ``keystone/<name>`` profiler range.

    ``parent`` hands a REMOTE context in directly — shorthand for
    ``with attach(ctx), span(name)`` on threads with no open span (the
    worker request path), skipping the attach scope. An open span on
    this thread still wins: nesting is local first, like attach."""
    session = _session
    if session is None:
        return _NOOP_SPAN_CM
    stack = _stack()
    if stack:
        top = stack[-1]
        trace_id, parent_id = top.trace_id, top.span_id
    else:
        attached: Optional[TraceContext] = (
            parent
            if parent is not None
            else getattr(_state, "attached", None)
        )
        if attached is not None:
            trace_id, parent_id = attached
        else:
            trace_id, parent_id = session.trace_id, None
    thread_id, thread_name = _thread_info()
    record = Span(
        name=name,
        trace_id=trace_id,
        span_id=_new_id(),
        parent_id=parent_id,
        start_s=0.0,  # stamped in __enter__, where the stack push lives
        attributes=attributes,
        thread_id=thread_id,
        thread_name=thread_name,
    )
    return _SpanContext(record, stack, session, _device.annotations_enabled())


def record_span(
    name: str,
    start_s: float,
    end_s: float,
    parent: Optional[TraceContext] = None,
    **attributes: Any,
) -> Optional[Span]:
    """Synthesize an already-finished span from measured timestamps (the
    serving worker reconstructs request spans from queue/apply timings this
    way). ``parent`` re-parents it under a captured context."""
    session = _session
    if session is None:
        return None
    if parent is not None:
        trace_id, parent_id = parent
    else:
        trace_id, parent_id = session.trace_id, None
    thread_id, thread_name = _thread_info()
    record = Span(
        name=name,
        trace_id=trace_id,
        span_id=_new_id(),
        parent_id=parent_id,
        start_s=start_s,
        end_s=end_s,
        attributes=dict(attributes),
        thread_id=thread_id,
        thread_name=thread_name,
    )
    session.add(record)
    return record


def current_span():
    """The innermost active span on this thread (NOOP_SPAN when none)."""
    if _session is None:
        return NOOP_SPAN
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else NOOP_SPAN


def current_context() -> Optional[TraceContext]:
    """(trace_id, span_id) handoff token for cross-thread continuation, or
    None when not tracing. On a thread with no open span but an attached
    remote context (a worker pipe thread continuing a supervisor trace),
    the ATTACHED context is the answer — a second hop of handoff must
    keep the originating trace, not restart at the local session root."""
    if _session is None:
        return None
    stack = getattr(_state, "stack", None)
    if stack:
        return stack[-1].context()
    attached: Optional[TraceContext] = getattr(_state, "attached", None)
    if attached is not None:
        return attached
    return (_session.trace_id, "")


def add_span_event(name: str, **attributes: Any) -> None:
    """Attach an event to the current span; single global read when
    tracing is off, so callers (retry loops, ladders) never gate on it."""
    if _session is None:
        return
    stack = getattr(_state, "stack", None)
    if stack:
        stack[-1].add_event(name, **attributes)


class _AttachContext:
    """Slotted attach scope (see :class:`_SpanContext` for why this is
    not ``@contextmanager``). The attachment is installed at
    construction — ``with attach(ctx):`` evaluates it immediately — and
    restored on exit."""

    __slots__ = ("_prev",)

    def __init__(self, context: Optional[TraceContext]):
        self._prev = getattr(_state, "attached", None)
        _state.attached = context

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        _state.attached = self._prev
        return False


def attach(context: Optional[TraceContext]) -> "_AttachContext":
    """Continue a trace captured on another thread: spans opened inside
    parent under ``context`` instead of starting a new root."""
    return _AttachContext(context)
