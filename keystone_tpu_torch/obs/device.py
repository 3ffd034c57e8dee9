"""Device/profiling hooks: memory sampling, peak-memory attribution, and
optional trace annotations.

Port of ``keystone_tpu/obs/device.py``. Memory sampling reads the card's
own accounting (``torch.cuda.memory_stats(device)``:
``allocated_bytes.all.current`` / ``.peak``) on an explicit CUDA device,
and host RSS (``/proc/self/statm``, then ``resource``) otherwise, as the
JAX package does on its CPU meshes. Either way the snapshot says which
source it used, so a reader never mistakes RSS for device memory.
:func:`per_device_snapshots` takes one snapshot per distinct card of a
mesh (default the ambient one) and one host-RSS entry, labelled
``host``, for its CPU shards; :func:`publish_per_device_memory` and
:func:`device_obs_payload` publish and embed them, as the JAX package's
do for its multi-device runs.

:func:`annotations_enabled` is the switch (default off,
``KEYSTONE_DEVICE_ANNOTATIONS``, read at call time;
:func:`set_device_annotations` overrides it) under which every span of
an open session (``obs/spans.py``) is also a
``torch.profiler.record_function`` range and, on a card, an NVTX range,
so the executor's nodes and the solvers' and featurizers' steps show up
inside a ``torch.profiler`` capture. It is off by default because a
range only helps under an active profiler and costs a host call.

Imports torch lazily; importable without it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
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


def per_device_snapshots(mesh: Any = None) -> list:
    """One memory snapshot per distinct device of ``mesh`` (default: the
    ambient mesh), labelled ``cuda:<i>`` for a card, in mesh order. The
    CPU shards of a mesh collapse to ONE host-RSS entry labelled
    ``host``: per-shard RSS attribution would be fiction. A card whose
    statistics call fails gives an error entry instead of vanishing."""
    from ..parallel.mesh import get_mesh

    mesh = mesh if mesh is not None else get_mesh()
    out, seen, host = [], set(), False
    for dev in mesh.flat_devices:
        if dev in seen:
            continue
        seen.add(dev)
        if dev.type != "cuda":
            host = True
            continue
        label = f"cuda:{dev.index}"
        try:
            snap = memory_snapshot(dev)
        except Exception as e:  # the card most likely wedged is this one
            out.append({"device": label, "source": "error", "error": f"{type(e).__name__}: {e}"})
            continue
        snap["device"] = label
        out.append(snap)
    if host or not out:
        snap = memory_snapshot(None)
        snap["device"] = "host"
        out.append(snap)
    return out


def publish_per_device_memory(stage: Optional[str] = None, mesh: Any = None) -> list:
    """Publish one gauge series per distinct device of ``mesh`` (one card
    running out while seven idle is invisible in the aggregate) and
    return the snapshots."""
    snaps = per_device_snapshots(mesh)
    in_use = names.metric(names.MEMORY_IN_USE_BYTES)
    peak = names.metric(names.PEAK_MEMORY_BYTES)
    for snap in snaps:
        if "error" in snap:
            continue  # an error entry carries no bytes
        in_use.set(snap["bytes_in_use"], source=snap["source"], device=snap["device"])
        if stage is not None:
            peak.max(snap["peak_bytes_in_use"], stage=stage, device=snap["device"])
    return snaps


def device_obs_payload(snapshots: Optional[list] = None, mesh: Any = None) -> Dict[str, Any]:
    """The per-device observability payload a multi-shard run embeds in
    its artifact: per-device memory (``snapshots`` reuses an
    already-taken sample, so the published gauges and the payload agree)
    and how many shards each device holds."""
    from ..parallel.mesh import get_mesh

    mesh = mesh if mesh is not None else get_mesh()
    return {
        "devices": per_device_snapshots(mesh) if snapshots is None else snapshots,
        "shards_per_device": {str(d): n for d, n in mesh.shards_per_device().items()},
        "mesh_shape": dict(mesh.global_shape),
    }


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
