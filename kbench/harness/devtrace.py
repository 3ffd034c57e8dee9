"""The traced run's instrumentation and the reduction of its profiler
trace to numbers.

:class:`Probe` puts ``record_function`` ranges, from the benchmark's own
code, around calls into the port: every call of the cuBLAS binding's
Python entry points (``ops/cuda/gemm.py``: its shape and product kind
are recorded too) and the layer entry points a configuration names
(``"layer_calls"`` in its file). The port itself is not edited; the
ranges are installed for the traced run only and removed after it.

:func:`reduce_trace` reads the Chrome trace ``torch.profiler`` exports:
device kernels, copies and sets (busy time, idle gaps, time by kernel
name), each kernel tied to the host range that launched it through the
launch's correlation id, so the device seconds of each binding call and
each layer are the kernels launched inside its range.
"""

from __future__ import annotations

import heapq
import importlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

GEMM_PREFIX = "kbench.gemm#"
LAYER_PREFIX = "kbench.layer."
WINDOW_NAME = "kbench.window"

_GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class GemmCall:
    fn: str
    m: int
    n: int
    k: int
    batch: int
    kind: str
    itemsize: int
    accumulate: bool
    #: Both operands are one matrix, the product its Gram AᵀA (or AAᵀ):
    #: the symmetric result needs about half the operations.
    gram: bool = False


def _resolve(target: str):
    """``"pkg.module:Attr.sub"`` → (owner object, attribute name)."""
    module_name, _, path = target.partition(":")
    owner: Any = importlib.import_module(module_name)
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1]


class Probe:
    """Ranges around the binding's calls and the configuration's layer
    entry points; ``install()`` / ``uninstall()`` bracket the traced run."""

    def __init__(self, layer_calls: Optional[Dict[str, List[str]]] = None):
        self.layer_calls = layer_calls or {}
        self.gemm_calls: List[GemmCall] = []
        self._saved: List[Tuple[Any, str, Any]] = []

    def install(self) -> None:
        from keystone_tpu_torch.ops.cuda import gemm as binding

        for fn_name in ("gemm", "gemm_tn_chunked", "gemm_batched"):
            self._patch(binding, fn_name, self._gemm_wrapper(fn_name, getattr(binding, fn_name)))
        for layer, targets in self.layer_calls.items():
            for target in targets:
                owner, attr = _resolve(target)
                self._patch(owner, attr, _ranged(LAYER_PREFIX + layer, getattr(owner, attr)))

    def uninstall(self) -> None:
        while self._saved:
            owner, attr, original = self._saved.pop()
            setattr(owner, attr, original)

    def _patch(self, owner, attr, replacement) -> None:
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, replacement)

    def _gemm_wrapper(self, fn_name: str, original):
        from keystone_tpu_torch.ops.cuda import gemm as binding

        calls = self.gemm_calls

        def wrapper(a, b, kind="ieee_fp32", *args, **kwargs):
            if a.device.type != "cuda":
                return original(a, b, kind, *args, **kwargs)
            resolved = binding.resolve_kind(kind, a.dtype)
            if fn_name == "gemm":
                m, k, n, batch = a.shape[0], a.shape[1], b.shape[1], 1
                beta = kwargs.get("beta", args[1] if len(args) > 1 else 0.0)
                gram = _same_matrix(a.T, b)
            elif fn_name == "gemm_tn_chunked":
                k, m, n, batch = a.shape[0], a.shape[1], b.shape[1], 1
                beta = kwargs.get("beta", args[1] if len(args) > 1 else 0.0)
                gram = _same_matrix(a, b)
            else:
                batch, m, k, n = a.shape[0], a.shape[1], a.shape[2], b.shape[2]
                beta = 0.0
                gram = _same_matrix(a.transpose(1, 2), b)
            index = len(calls)
            calls.append(GemmCall(fn_name, m, n, k, batch, resolved, a.element_size(), beta != 0.0, gram))
            with torch.profiler.record_function(f"{GEMM_PREFIX}{index}"):
                return original(a, b, kind, *args, **kwargs)

        return wrapper


def _same_matrix(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether two operands are views of one matrix in one layout."""
    return (x.data_ptr() == y.data_ptr() and tuple(x.shape) == tuple(y.shape)
            and tuple(x.stride()) == tuple(y.stride()))


def _ranged(name: str, original):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return original(*args, **kwargs)

    wrapper.__wrapped__ = original
    return wrapper


class Profiler:
    """``torch.profiler`` over the traced window, exported to a temporary
    Chrome trace under ``TMPDIR`` and reduced by :func:`reduce_trace`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, record_shapes=False, with_stack=False)
        self._window = None

    def start(self) -> None:
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_NAME)
        self._window.__enter__()

    def start_and_discard(self) -> None:
        """Start and stop once, keeping nothing: the device tracer's
        one-time initialisation, done in set-up."""
        self._prof.__enter__()
        self._prof.__exit__(None, None, None)

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self) -> "TraceSummary":
        """The stopped trace, exported and reduced (call once the load
        it measured has finished: the export holds the interpreter)."""
        fd, path = tempfile.mkstemp(prefix="kbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return reduce_trace(data)


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: int = 0
    #: Device seconds by kernel (or copy) name, over the window.
    device_ops: Dict[str, float] = field(default_factory=dict)
    #: Idle seconds of the device by what the host was doing.
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    #: Device seconds of kernels launched inside each layer's ranges.
    layer_s: Dict[str, float] = field(default_factory=dict)
    #: Device seconds of the kernels of each binding call, by call index.
    gemm_s: Dict[int, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def _containing(intervals: List[Tuple[float, float, str]], points: List[Tuple[float, Any]]):
    """For each point (ts, key), the intervals (start, end, name) holding ts."""
    intervals = sorted(intervals)
    points = sorted(points, key=lambda p: p[0])
    active: List[Tuple[float, int]] = []
    out: Dict[Any, List[Tuple[float, float, str]]] = {}
    i = 0
    for ts, key in points:
        while i < len(intervals) and intervals[i][0] <= ts:
            heapq.heappush(active, (intervals[i][1], i))
            i += 1
        while active and active[0][0] < ts:
            heapq.heappop(active)
        if active:
            out[key] = [intervals[j] for _, j in active]
    return out


def reduce_trace(data: Any) -> TraceSummary:
    """Reduce a Chrome trace (the dict ``export_chrome_trace`` writes)."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    window = None
    gpu: List[Tuple[float, float, str, Any]] = []
    launches: Dict[Any, Tuple[Any, float]] = {}
    ranges: Dict[Any, List[Tuple[float, float, str]]] = defaultdict(list)
    host: List[Tuple[float, float, str]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if cat in _GPU_CATS:
            gpu.append((ts, dur, name, args.get("correlation")))
        elif cat in _LAUNCH_CATS:
            if "correlation" in args:
                launches[args["correlation"]] = (ev.get("tid"), ts)
        elif cat == "user_annotation":
            if name == WINDOW_NAME:
                window = (ts, ts + dur)
            elif name.startswith("kbench."):
                ranges[ev.get("tid")].append((ts, ts + dur, name))
            host.append((ts, ts + dur, name))
        elif cat == "cpu_op":
            host.append((ts, ts + dur, name))
    summary = TraceSummary()
    if window is None:
        return summary
    w0, w1 = window
    summary.window_s = (w1 - w0) / 1e6
    clipped = []
    for ts, dur, name, corr in gpu:
        start, end = max(ts, w0), min(ts + dur, w1)
        if end <= start:
            continue
        clipped.append((start, end))
        summary.kernels += 1
        summary.device_ops[name[:160]] = summary.device_ops.get(name[:160], 0.0) + (end - start) / 1e6
    busy = _merge(clipped)
    summary.busy_s = sum(e - s for s, e in busy) / 1e6

    # Idle gaps inside the window, labelled by the narrowest host range
    # (an annotation or an operator) holding the gap's midpoint.
    gaps = []
    cursor = w0
    for start, end in busy:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if w1 > cursor:
        gaps.append((cursor, w1))
    narrowest = [(s, e, n) for s, e, n in host if n != WINDOW_NAME]
    holders = _containing(narrowest, [((s + e) / 2.0, i) for i, (s, e) in enumerate(gaps)])
    for i, (start, end) in enumerate(gaps):
        held = holders.get(i)
        label = min(held, key=lambda h: h[1] - h[0])[2] if held else "no host range"
        summary.idle_by_host[label[:160]] = summary.idle_by_host.get(label[:160], 0.0) + (end - start) / 1e6

    # Kernels tied to the harness's ranges through their launches.
    by_tid: Dict[Any, List[Tuple[float, Any]]] = defaultdict(list)
    for idx, (ts, dur, name, corr) in enumerate(gpu):
        if corr in launches:
            tid, launch_ts = launches[corr]
            by_tid[tid].append((launch_ts, idx))
    for tid, points in by_tid.items():
        held = _containing(ranges.get(tid, []), points)
        for idx, holding in held.items():
            names = [h[2] for h in holding]
            ts, dur, _, _ = gpu[idx]
            start, end = max(ts, w0), min(ts + dur, w1)
            if end <= start:
                continue
            seconds = (end - start) / 1e6
            for layer in {n[len(LAYER_PREFIX):] for n in names if n.startswith(LAYER_PREFIX)}:
                summary.layer_s[layer] = summary.layer_s.get(layer, 0.0) + seconds
            for n in names:
                if n.startswith(GEMM_PREFIX):
                    call = int(n[len(GEMM_PREFIX):])
                    summary.gemm_s[call] = summary.gemm_s.get(call, 0.0) + seconds
    return summary
