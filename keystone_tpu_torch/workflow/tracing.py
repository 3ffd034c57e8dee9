"""Per-operator execution tracing, backed by the span layer.

Port of ``keystone_tpu/workflow/tracing.py``. ``with trace() as t:``
opens a real :class:`~keystone_tpu_torch.obs.spans.TraceSession` (``t.session``)
with a ``pipeline`` root span; each operator the executor forces becomes
a ``node:<label>`` child span (attribute ``op``, the operator's type;
``fused_members`` on a fused chain), its wall time is recorded as
``(label, seconds)`` in ``t.timings`` and observed in the
``keystone_executor_node_seconds`` histogram labelled by ``op=<label>``.
Timing forces each operator's lazy result and, when a leaf of it lies on
a CUDA device, waits for the device (``torch.cuda.synchronize()``), so a
node's seconds cover its device work. Under a span session opened
without ``trace()`` the executor opens the same node spans; it waits for
the device only when the session asks for real timings
(``sync_timings``, the default), and otherwise records dispatch time,
marked ``synced=False`` (a serving worker's session). With neither,
nothing is forced or synchronized and operators keep their laziness.

With the cost observatory enabled (``obs/cost.py``, ``KEYSTONE_COST_OBS``)
each forcing runs inside a harvest frame: the launch sites (the cuBLAS
binding, the ELL kernel) note their launches into it, and the frame is
finalized into a perf-ledger entry (predicted cost, measured wall,
flop/byte facts, roofline placement) AFTER the wall measurement. A node
during which nvcc built a kernel library or cuFFT created a plan is
marked cold (never drift-scored), the port's counterpart of the JAX
package's compile counter. With device
annotations on (``obs/device.py``) each node's forcing is a
``torch.profiler.record_function`` range.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from ..obs import cost as _cost
from ..obs import names as _names
from ..obs import spans as _spans
from ..obs.device import device_annotation
from ..utils.tree import tree_leaves


@dataclass
class OpTiming:
    label: str
    seconds: float


@dataclass
class PipelineTrace:
    """Flat view of one traced run; ``session`` carries the underlying
    span session for callers that want the hierarchy."""

    timings: List[OpTiming] = field(default_factory=list)
    session: Optional[Any] = None  # obs.spans.TraceSession

    def record(self, label: str, seconds: float) -> None:
        self.timings.append(OpTiming(label, seconds))

    @property
    def total_seconds(self) -> float:
        return sum(t.seconds for t in self.timings)

    def report(self) -> str:
        """Pretty table, slowest first."""
        rows = sorted(self.timings, key=lambda t: -t.seconds)
        width = max([len("operator"), len("TOTAL")] + [len(t.label) for t in rows])
        lines = [f"{'operator':<{width}}  seconds"]
        for t in rows:
            lines.append(f"{t.label:<{width}}  {t.seconds:8.4f}")
        lines.append(f"{'TOTAL':<{width}}  {self.total_seconds:8.4f}")
        return "\n".join(lines)


_local = threading.local()


def current_trace() -> Optional[PipelineTrace]:
    return getattr(_local, "trace", None)


@contextmanager
def trace():
    """Context manager: trace all pipeline executions in this thread.

    >>> with trace() as t:
    ...     pipeline(data).get()
    >>> print(t.report())

    Also opens (or joins) a span session with a ``pipeline`` root span.
    """
    prev = current_trace()
    tr = PipelineTrace()
    _local.trace = tr
    try:
        with _spans.tracing_session("pipeline") as session:
            tr.session = session
            with _spans.span("pipeline"):
                yield tr
    finally:
        _local.trace = prev


def _force(value: Any) -> None:
    """Wait for the device work behind ``value``: a dataset is unwrapped
    to its tensors, and if any of them lies on a CUDA device the device
    is synchronized."""
    data = getattr(value, "data", value)
    for leaf in tree_leaves(data):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            # The sync_timings wait itself: callers reach it only under
            # `if sync`.  # keystone: allow-sync
            torch.cuda.synchronize(leaf.device)
            return


def _compile_events() -> int:
    """The port's counterpart of the JAX package's compile count: kernel
    libraries nvcc built in this process, plus cuFFT plans created on
    the current card (each a first-shape cost a warm node does not pay)."""
    from ..ops.cuda import _build

    events = sum(1 for s in _build.build_seconds.values() if s > 0)
    if torch.cuda.is_initialized():
        events += torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()].size
    return events


def timed_execute(op, deps):
    """Execute ``op``; under an active :func:`trace` or span session,
    record the node's span, wall time and histogram observation, forcing
    the result and waiting for the device when the trace or the session
    needs real timings. With the cost observatory on (and no session) a
    node's seconds measure dispatch, marked ``synced=False``."""
    tr = current_trace()
    session = _spans.active_session()
    expression = op.execute(deps)
    cost_on = _cost.cost_observatory_enabled()
    if tr is None and session is None and not cost_on:
        return expression
    sync = tr is not None or (session is not None and session.sync_timings)
    label = str(getattr(op, "label", type(op).__name__))
    members = getattr(op, "member_labels", None)
    frame = _cost.push_frame(label) if cost_on else None
    with _spans.span(f"node:{label}", op=type(op).__name__) as sp:
        if members is not None:
            sp.set_attribute("fused_members", ",".join(members))
        try:
            if frame is not None:
                compiles_before = _compile_events()
            with device_annotation(f"keystone/node/{label}"):
                start = time.perf_counter()
                value = expression.get()
                if sync:
                    _force(value)
                seconds = time.perf_counter() - start
        finally:
            if frame is not None:
                frame.compiles = _compile_events() - compiles_before
                _cost.pop_frame(frame)
        sp.set_attribute("seconds", round(seconds, 6))
        if not sync:
            sp.set_attribute("synced", False)
    if frame is not None:
        _cost.finalize_node(label, seconds, sync, op=op, span=sp, frame=frame)
    if tr is not None:
        tr.record(label, seconds)
    if tr is not None or session is not None:
        _names.metric(_names.NODE_SECONDS).observe(seconds, op=label)
    return expression
