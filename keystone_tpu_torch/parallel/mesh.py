"""Device meshes for one controlling process.

Port of ``keystone_tpu/parallel/mesh.py``. The JAX package holds a
``jax.sharding.Mesh`` over ``jax.devices()``; the port holds a
:class:`Mesh`: named axes over an array of ``torch.device`` values, with
the same axis conventions —

- ``data``  — example (row) sharding: every solver's Gram or gradient
  accumulation is data-parallel over this axis;
- ``model`` — feature (column) sharding for the block solvers and the
  2-D streamed fits.

A mesh may name the same device more than once. ``make_mesh()`` covers
the visible cards (one shard on a one-card machine, or the CPU when there
is no card), so every path keeps its single-device plan; a test or a
smoke run asks for eight shards on one card with
``make_mesh(devices=[torch.device("cuda", 0)] * 8)`` (``"cpu"`` on a
machine without one). Eight shards on one card run everything the
multi-device tier decides and computes; only the transfers between two
cards are left out.

Waiting for ROADMAP item 14b: ``make_hybrid_mesh`` (the ``replica``
axis), ``mesh_without`` (shard-loss recovery) and ``distributed_init``
(multi-host). :func:`row_axes` already reads a ``replica`` axis, as the
JAX package's does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: Outer axis spanning hosts in the JAX package's hybrid meshes (14b).
REPLICA_AXIS = "replica"


def _normalize(device) -> torch.device:
    """``device`` with an explicit index on a card (``cuda`` → ``cuda:0``
    under the current device), so that two spellings of one card compare
    equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a, b) -> bool:
    """True when ``a`` and ``b`` name the same device (``cuda`` and
    ``cuda:0`` do, on a machine whose current card is 0)."""
    return _normalize(a) == _normalize(b)


def _check_present(device: torch.device) -> None:
    """Raise when ``device`` names a card the machine does not have."""
    if device.type == "cpu":
        return
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device.index is None or device.index >= count:
            raise ValueError(f"mesh device {device} is not present ({count} CUDA devices visible)")
        return
    raise ValueError(f"mesh device {device}: only 'cpu' and 'cuda' devices can form a mesh")


class Mesh:
    """Named axes over an array of devices. ``devices`` is an object
    array of ``torch.device`` whose shape is the mesh shape; flat
    (row-major) order is shard order. ``shape`` maps each axis name to
    its size, in axis order, as the JAX mesh's ``shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> Tuple[torch.device, ...]:
        """Every shard's device, in shard (flat, row-major) order."""
        return tuple(self.devices.flat)

    def coords(self, flat_index: int) -> Dict[str, int]:
        """The axis coordinates of shard ``flat_index``."""
        return dict(zip(self.axis_names, np.unravel_index(flat_index, self.devices.shape)))

    def shards_per_device(self) -> Dict[torch.device, int]:
        """How many shards each distinct device holds."""
        out: Dict[torch.device, int] = {}
        for d in self.flat_devices:
            out[d] = out.get(d, 0) + 1
        return out

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        names = sorted({str(d) for d in self.flat_devices})
        return f"Mesh({shape}; devices={names})"


_current_mesh: Optional[Mesh] = None


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the example (row) dimension is sharded over: ``data``,
    plus the outer ``replica`` axis on a hybrid mesh."""
    if REPLICA_AXIS in mesh.shape:
        return (REPLICA_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def row_shard_count(mesh: Mesh) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in row_axes(mesh))


def model_axis_size(mesh: Mesh) -> int:
    """Feature-block shards the mesh carries (1 when no ``model`` axis)."""
    return mesh.shape.get(MODEL_AXIS, 1)


def visible_devices() -> Tuple[torch.device, ...]:
    """The visible cards, or the CPU on a machine without one."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: :func:`visible_devices`). With no
    ``shape``: a 1-D ``data`` mesh over every device given. A device may
    repeat; one that is not present raises."""
    devs = [_normalize(d) for d in (devices if devices is not None else visible_devices())]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        _check_present(d)
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} does not cover {len(devs)} devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


# One reshaped 2-D mesh per (base devices, model shards): the partitioner
# re-decides every plan, and consumers key caches on mesh identity.
_model_mesh_cache: dict = {}


def model_mesh(base: Mesh, model_shards: int) -> Mesh:
    """The ``(data, model)`` mesh over ``base``'s devices with the feature
    axis split ``model_shards`` ways. Cached on (device tuple, shards), so
    repeated plans hand back the SAME object. ``model_shards`` must divide
    the device count."""
    devices = base.flat_devices
    if len(devices) % model_shards != 0:
        raise ValueError(f"{model_shards} model shards do not divide {len(devices)} devices")
    key = (devices, int(model_shards))
    hit = _model_mesh_cache.get(key)
    if hit is None:
        hit = make_mesh(
            (len(devices) // model_shards, model_shards), (DATA_AXIS, MODEL_AXIS), devices=devices
        )
        _model_mesh_cache[key] = hit
    return hit


def get_mesh() -> Mesh:
    """The active mesh (``make_mesh()`` if none was set)."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def data_axis_size(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape.get(DATA_AXIS, 1)


def num_devices() -> int:
    """Devices ``make_mesh()`` covers: the visible cards, or 1 (the CPU)."""
    return len(visible_devices())


def device_memory_budget_bytes(fraction: float = 0.75, mesh: Optional[Mesh] = None) -> int:
    """Per-SHARD memory budget for residency planning: ``fraction`` of the
    free memory of the first shard's card, divided by the number of the
    mesh's shards mapped to that card. The CPU (no memory statistics)
    reads 4e9 bytes, as the JAX package's CPU fallback does, divided the
    same way."""
    mesh = mesh or get_mesh()
    device = mesh.flat_devices[0]
    per_card = mesh.shards_per_device()[device]
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * fraction) // per_card
    return int(4e9 * fraction) // per_card


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "REPLICA_AXIS",
    "data_axis_size",
    "device_memory_budget_bytes",
    "get_mesh",
    "make_mesh",
    "model_axis_size",
    "model_mesh",
    "num_devices",
    "row_axes",
    "row_shard_count",
    "same_device",
    "set_mesh",
    "use_mesh",
    "visible_devices",
]
