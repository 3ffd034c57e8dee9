"""Per-operator execution tracing.

Port of ``keystone_tpu/workflow/tracing.py``'s ``PipelineTrace`` view:
inside ``with trace() as t:`` every operator the executor forces is timed
and recorded as ``(label, seconds)``. Timing forces each operator's lazy
result and, when a leaf of it lies on a CUDA device, waits for the device
(``torch.cuda.synchronize()``), so a node's seconds cover its device work.
Tracing is a profiling mode: outside ``trace()`` nothing is forced or
synchronized and operators keep their laziness.

Left out for now: the span session, cost frames, the node-seconds
histogram and the compile counter of the JAX package.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from ..utils.tree import tree_leaves


@dataclass
class OpTiming:
    label: str
    seconds: float


@dataclass
class PipelineTrace:
    """Flat view of one traced run."""

    timings: List[OpTiming] = field(default_factory=list)

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
    """
    prev = current_trace()
    tr = PipelineTrace()
    _local.trace = tr
    try:
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
    wait for the device, and record the node's wall time."""
    tr = current_trace()
    expression = op.execute(deps)
    if tr is None:
        return expression
    label = str(getattr(op, "label", type(op).__name__))
    start = time.perf_counter()
    value = expression.get()
    _force(value)
    tr.record(label, time.perf_counter() - start)
    return expression
