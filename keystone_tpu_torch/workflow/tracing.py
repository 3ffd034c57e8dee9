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
node's seconds cover its device work. Tracing is a profiling mode:
outside ``trace()`` nothing is forced or synchronized, operators keep
their laziness and the executor opens no node spans.

Left out for now: the cost frames and the compile counter of the JAX
package, and node spans under a span session opened without ``trace()``
(the JAX package's ``sync_timings`` sessions).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from ..obs import names as _names
from ..obs import spans as _spans
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
            torch.cuda.synchronize(leaf.device)
            return


def timed_execute(op, deps):
    """Execute ``op``; under an active :func:`trace`, force the result,
    wait for the device, and record the node's span, wall time and
    histogram observation."""
    tr = current_trace()
    expression = op.execute(deps)
    if tr is None:
        return expression
    label = str(getattr(op, "label", type(op).__name__))
    members = getattr(op, "member_labels", None)
    with _spans.span(f"node:{label}", op=type(op).__name__) as sp:
        if members is not None:
            sp.set_attribute("fused_members", ",".join(members))
        start = time.perf_counter()
        value = expression.get()
        _force(value)
        seconds = time.perf_counter() - start
        sp.set_attribute("seconds", round(seconds, 6))
    tr.record(label, seconds)
    _names.metric(_names.NODE_SECONDS).observe(seconds, op=label)
    return expression
