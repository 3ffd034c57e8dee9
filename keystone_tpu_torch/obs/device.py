"""Device/profiling hooks: memory sampling, peak-memory attribution, and
optional trace annotations.

Port of ``keystone_tpu/obs/device.py``. Memory sampling reads the card's
own accounting (``torch.cuda.memory_stats(device)``:
``allocated_bytes.all.current`` / ``.peak``) on an explicit CUDA device,
and host RSS (``/proc/self/statm``, then ``resource``) otherwise, as the
JAX package does on its CPU meshes. Either way the snapshot says which
source it used, so a reader never mistakes RSS for device memory. The
JAX package's per-device snapshots and payload serve its multichip
dry runs and come with ROADMAP item 14b.

``device_annotation`` wraps a code region in
``torch.profiler.record_function`` and, on a card, an NVTX range, so
per-node executor work shows up inside a ``torch.profiler`` capture. It
is gated (default off, ``KEYSTONE_DEVICE_ANNOTATIONS``) because an
annotation only helps under an active profiler and costs a host call.

Imports torch lazily; importable without it.
"""

from __future__ import annotations

import os
from contextlib import ExitStack, contextmanager, nullcontext
from typing import Any, Dict, Iterator, Optional

from ..envknobs import env_flag
from . import names, spans

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# Tri-state: None → read the env at CALL time.
_annotations_enabled: "bool | None" = None


def set_device_annotations(enabled: "bool | None") -> None:
    """Force annotations on/off process-wide; ``None`` restores the env
    default."""
    global _annotations_enabled
    _annotations_enabled = enabled


def annotations_enabled() -> bool:
    if _annotations_enabled is not None:
        return _annotations_enabled
    return env_flag("KEYSTONE_DEVICE_ANNOTATIONS")


@contextmanager
def _annotated(name: str) -> Iterator[None]:
    import torch

    with ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def device_annotation(name: str):
    """Context manager: ``torch.profiler.record_function(name)`` (plus an
    NVTX range with a card present) when enabled, else a no-op."""
    if not annotations_enabled():
        return nullcontext()
    return _annotated(name)


def rss_bytes() -> int:
    """Resident set size of this process (0 if unavailable)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except Exception:
        pass
    try:
        import resource

        # ru_maxrss is the PEAK, in KiB on Linux — last resort only.
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def peak_rss_bytes() -> int:
    """Process-lifetime peak RSS (0 if unavailable)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def _cuda_device(device: Any) -> Any:
    """``device`` as a CUDA ``torch.device``, or None when it names none
    (or torch is not loaded)."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def memory_snapshot(device: Any = None) -> Dict[str, Any]:
    """Best-available memory numbers right now.

    Returns ``{"source": "device"|"rss", "bytes_in_use": int,
    "peak_bytes_in_use": int}``: the card's allocator counters for a CUDA
    ``device``, host RSS for ``None`` or the CPU."""
    dev = _cuda_device(device)
    if dev is not None:
        import torch

        stats = torch.cuda.memory_stats(dev)
        return {
            "source": "device",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }
    return {
        "source": "rss",
        "bytes_in_use": rss_bytes(),
        "peak_bytes_in_use": peak_rss_bytes(),
    }


def publish_memory(stage: Optional[str] = None, device: Any = None) -> Dict[str, Any]:
    """Sample memory on ``device`` (host RSS for None) and publish it: the
    aggregate in-use gauge (``device="all"``) always, plus per-stage peak
    attribution when ``stage`` is given."""
    snap = memory_snapshot(device)
    names.metric(names.MEMORY_IN_USE_BYTES).set(
        snap["bytes_in_use"], source=snap["source"], device="all"
    )
    if stage is not None:
        names.metric(names.PEAK_MEMORY_BYTES).max(
            snap["peak_bytes_in_use"], stage=stage, device="all"
        )
    return snap


@contextmanager
def stage_memory(stage: str, device: Any = None) -> Iterator[None]:
    """Attribute peak memory to a pipeline stage: snapshot before/after,
    stamp the delta and peak onto the current span, and keep the per-stage
    peak gauge. Callers gate per-node use on an active span session."""
    before = publish_memory(stage=stage, device=device)
    try:
        yield
    finally:
        after = publish_memory(stage=stage, device=device)
        sp = spans.current_span()
        sp.set_attribute("mem_bytes_before", before["bytes_in_use"])
        sp.set_attribute("mem_bytes_after", after["bytes_in_use"])
        sp.set_attribute("mem_peak_bytes", after["peak_bytes_in_use"])
        sp.set_attribute("mem_source", after["source"])
