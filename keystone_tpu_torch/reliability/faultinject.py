"""Deterministic fault injection: make a probed code site raise OOM, hang
past a deadline, raise a transient error, or return corrupt data on
chosen calls — so recovery paths are exercised by ordinary tests instead
of waiting for a real failure.

A copy of ``keystone_tpu/reliability/faultinject.py`` without its
process-level parts (the ``kill`` kind and the environment carry of
specs to worker processes), which belong to the multi-worker runtime the
port does not have yet.

Library code calls ``probe("site-name")`` at its retryable boundaries. A
no-op (one global ``is None`` check) unless an injector is active, so
production paths pay nothing. ``FaultInjector.wrap`` wraps a thunk so a
``corrupt`` spec can poison its result.

Faults are deterministic: specs name exact 1-based call numbers (or a
``first_n`` prefix) per matched label, and the injector counts calls —
including retried ones, which is exactly what lets a test say "fail the
first two attempts, succeed on the third".
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_map
from .recovery import get_recovery_log


class InjectedOOM(RuntimeError):
    """Injected allocator failure; message classifies as OOM."""

    def __init__(self, label: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected OOM at {label} (faultinject)"
        )


class InjectedTransient(ConnectionError):
    """Injected relay/coordinator failure; message classifies as transient."""

    def __init__(self, label: str):
        super().__init__(f"UNAVAILABLE: injected transient fault at {label}")


@dataclass(frozen=True)
class FaultSpec:
    """What to inject, where, and on which calls.

    ``match``   — substring of the probe site ("*" = every site).
    ``kind``    — "oom" | "transient" | "hang" | "corrupt".
    ``calls``   — exact 1-based call numbers to fault at.
    ``first_n`` — alternative to ``calls``: fault calls 1..first_n.
    ``hang_s``  — sleep length for kind="hang" (pair with a policy whose
                  ``deadline_s`` is shorter to exercise the watchdog).
    ``corrupt`` — value transform for kind="corrupt" (default NaN-fills
                  floating tensors and arrays, the shape-preserving
                  corruption a consumer actually notices; strings garble
                  into non-JSON bytes).
    """

    match: str
    kind: str = "oom"
    calls: Tuple[int, ...] = (1,)
    first_n: Optional[int] = None
    hang_s: float = 60.0
    corrupt: Optional[Callable[[Any], Any]] = None

    def applies(self, label: str, call_number: int) -> bool:
        if self.match != "*" and self.match not in label:
            return False
        if self.first_n is not None:
            return call_number <= self.first_n
        return call_number in self.calls


def _nan_corrupt(value: Any) -> Any:
    if isinstance(value, str):
        return "\x00garbled\x00" + value[::-1][: max(len(value) // 2, 1)]

    # Dataset-like wrappers (ArrayDataset): poison the payload, keep the
    # wrapper type so downstream dispatch is unchanged.
    data = getattr(value, "data", None)
    if data is not None and hasattr(value, "num_examples"):
        return type(value)(_nan_corrupt(data), value.num_examples)

    def poison(leaf):
        if isinstance(leaf, torch.Tensor):
            out = leaf.clone()
            if out.is_floating_point():
                out.fill_(float("nan"))
            return out
        if isinstance(leaf, np.ndarray):
            out = leaf.copy()
            if np.issubdtype(out.dtype, np.floating):
                out.fill(np.nan)
            return out
        return leaf

    return tree_map(poison, value)


class FaultInjector:
    """Holds specs + per-label call counts; install via :func:`injected`."""

    def __init__(self, *specs: FaultSpec, sleep: Callable[[float], None] = time.sleep):
        self.specs = specs
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def calls(self, label: str) -> int:
        with self._lock:
            return self._counts.get(label, 0)

    def _bump(self, label: str) -> int:
        with self._lock:
            self._counts[label] = self._counts.get(label, 0) + 1
            return self._counts[label]

    def check(self, label: str) -> None:
        """Raise/hang if a spec targets this call of ``label`` (corrupt
        specs are handled by :meth:`wrap`, which sees the value)."""
        n = self._bump(label)
        for spec in self.specs:
            if spec.kind == "corrupt" or not spec.applies(label, n):
                continue
            get_recovery_log().record(
                "fault", label, fault_kind=spec.kind, call_number=n
            )
            if spec.kind == "oom":
                raise InjectedOOM(label)
            if spec.kind == "transient":
                raise InjectedTransient(label)
            if spec.kind == "hang":
                self._sleep(spec.hang_s)
                return
            raise ValueError(f"unknown fault kind {spec.kind!r}")

    def wrap(self, label: str, thunk: Callable[[], Any]) -> Callable[[], Any]:
        def faulted():
            self.check(label)
            value = thunk()
            n = self.calls(label)
            for spec in self.specs:
                if spec.kind == "corrupt" and spec.applies(label, n):
                    get_recovery_log().record(
                        "fault", label, fault_kind="corrupt", call_number=n
                    )
                    value = (spec.corrupt or _nan_corrupt)(value)
            return value

        return faulted


_current: Optional[FaultInjector] = None

#: Every probe site the port exposes, by its exact label. Chaos specs
#: target sites by these names; a site is registered next to the code
#: that adds it. The JAX package registers more, and each arrives with
#: the module that probes it: the refit sites with refit, the worker and
#: shard-loss sites with the multi-worker and multi-device runtimes.
KNOWN_PROBE_SITES = frozenset(
    {
        "serving.apply",  # serving/server.py: per-batch apply
        "streaming.chunk",  # workflow/streaming.py: per-chunk dispatch
        "BlockLeastSquaresEstimator.solve",  # ops/learning/block.py: each ladder rung
        "LeastSquaresEstimator.solve",  # ops/learning/least_squares.py: each ladder rung
        "KernelRidgeRegression.solve",  # ops/learning/kernel.py: each ladder rung
        "sketch.finish",  # sketch/solvers.py: each finish rung
        "ingest.decode_batch",  # data/loaders/archive.py: each decode batch
    }
)


def current() -> Optional[FaultInjector]:
    """The active injector, or None (the executor wraps nodes only then)."""
    return _current


def probe(label: str) -> None:
    """Library-side injection point: no-op unless an injector is active."""
    injector = _current
    if injector is not None:
        injector.check(label)


@contextmanager
def injected(*specs: FaultSpec, sleep: Callable[[float], None] = time.sleep):
    """Activate a :class:`FaultInjector` for the dynamic extent of the
    block (process-wide — pipeline execution may cross threads)."""
    global _current
    if _current is not None:
        raise RuntimeError("fault injector already active (no nesting)")
    injector = FaultInjector(*specs, sleep=sleep)
    _current = injector
    try:
        yield injector
    finally:
        _current = None
