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

``make_hybrid_mesh`` adds the outer ``replica`` axis. In one process it
is an outer axis over the local devices (eight shards of one card as
2 × 4). Once :func:`distributed_init` has joined a ``torch.distributed``
group, ``make_hybrid_mesh(num_replicas=world_size)`` makes the ``replica``
axis the process group: each process holds its own ``data`` shards. Such
a mesh is this process's part of the whole: ``shape`` and ``devices``
hold the local shards (``replica`` extent 1), ``global_shape`` the whole
mesh, and the collectives cross processes on the ``replica`` axis
(``parallel/collectives.py``). The estimators, the partitioner and the
plans built on it take a mesh of one process only
(:func:`require_one_process`); across processes each process passes its
own rows to the sharded ``linalg`` reductions, as the two-process
rehearsal's ``gram`` does. ``mesh_without`` drops one shard after a loss
(the elastic fold's re-plan).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: Outer axis of a hybrid mesh (``make_hybrid_mesh``): local, or the
#: process group.
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

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], process_group: Optional[Tuple[int, int]] = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        #: (rank, world size) when the ``replica`` axis is a
        #: ``torch.distributed`` process group, else None.
        self.process_group = process_group

    @property
    def spans_processes(self) -> bool:
        return self.process_group is not None

    @property
    def global_shape(self) -> Dict[str, int]:
        """Every axis's size over the whole mesh: ``shape``, with the
        ``replica`` axis counting the processes of a process-spanning
        mesh."""
        if self.process_group is None:
            return dict(self.shape)
        return {a: (self.process_group[1] if a == REPLICA_AXIS else n) for a, n in self.shape.items()}

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
        shape = ", ".join(f"{a}={n}" for a, n in self.global_shape.items())
        names = sorted({str(d) for d in self.flat_devices})
        where = "" if self.process_group is None else f"; rank {self.process_group[0]} of {self.process_group[1]}"
        return f"Mesh({shape}; devices={names}{where})"


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


def require_one_process(mesh: Mesh, what: str) -> Mesh:
    """``mesh`` itself, unless it spans processes: ``what`` (an estimator,
    the partitioner, a plan) lays out the rows it is given over a mesh of
    this one process, and across processes it would have to be handed
    this process's part of them instead. The collectives and the sharded
    ``linalg`` reductions take such a mesh, each process passing its own
    rows; the two-process rehearsal's ``linalg.gram`` is the path that
    runs across processes (``parallel/rehearsal.py``)."""
    if mesh.spans_processes:
        raise ValueError(
            f"{what} shards over a mesh of one process, not {mesh}; across processes "
            "pass each process's rows to the sharded linalg reductions, as the rehearsal's gram does"
        )
    return mesh


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


def _process_world() -> Optional[Tuple[int, int]]:
    """(rank, world size) of the joined ``torch.distributed`` group, or
    None when none is joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def make_hybrid_mesh(num_replicas: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A (``replica``, ``data``) mesh, the JAX package's two-tier layout.

    In one process the ``replica`` axis is an outer axis over ``devices``
    (default :func:`visible_devices`), ``num_replicas`` (default 1) rows
    of ``len(devices) / num_replicas`` shards. When a
    ``torch.distributed`` group of more than one process is joined and
    ``num_replicas`` is its world size (or None), the ``replica`` axis is
    the process group and ``devices`` are this process's ``data`` shards.
    """
    world = _process_world()
    devs = [_normalize(d) for d in (devices if devices is not None else visible_devices())]
    for d in devs:
        _check_present(d)
    if world is not None and world[1] > 1 and num_replicas in (None, world[1]):
        if not devs:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        return Mesh(arr.reshape(1, len(devs)), (REPLICA_AXIS, DATA_AXIS), process_group=world)
    num_replicas = 1 if num_replicas is None else int(num_replicas)
    if num_replicas < 1 or len(devs) % num_replicas != 0:
        raise ValueError(f"{len(devs)} devices do not divide into {num_replicas} replicas")
    return make_mesh((num_replicas, len(devs) // num_replicas), (REPLICA_AXIS, DATA_AXIS), devices=devs)


def mesh_without(mesh: Mesh, shard_index: int) -> Mesh:
    """The shrunken mesh after losing the shard at FLAT index
    ``shard_index``: a 1-D ``data`` mesh over the surviving devices. The
    flat index covers every axis (on a 2-D ``(data, model)`` mesh it is
    ``data_idx·model_shards + model_idx``), so a loss on either axis
    shrinks through the same call; the elastic fold re-plans the layout
    on the survivors."""
    if mesh.spans_processes:
        raise ValueError("a shard of a mesh that spans processes cannot be dropped in one process")
    devices = [d for i, d in enumerate(mesh.flat_devices) if i != shard_index]
    if not devices:
        raise ValueError("cannot shrink a mesh below one device")
    return make_mesh(devices=devices)


#: Environment variables that say a ``torchrun``-style launcher started
#: this process (``init_method="env://"`` reads them).
_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the ``torch.distributed`` process group once per process,
    before any device use.

    Explicit coordination (the arguments, or ``KEYSTONE_COORDINATOR`` /
    ``KEYSTONE_NUM_HOSTS`` / ``KEYSTONE_HOST_ID``) calls
    ``init_process_group(init_method="tcp://<coordinator>", world_size,
    rank)``; a partial triple raises ``ValueError`` naming what is unset.
    Otherwise a launcher's ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``
    join through ``env://``. In either cluster environment an init
    failure propagates; with none it is a no-op.

    ``backend`` defaults to ``nccl`` when every rank has its own card and
    to ``gloo`` on a machine without one. NCCL refuses two ranks on one
    card, so a request for ``nccl`` with more ranks than cards raises,
    and so does the default when a card is present but shared: pass
    ``backend="gloo"``, which runs the same collectives on CUDA tensors
    through host copies. The backend is never switched quietly."""
    import torch.distributed as dist

    from ..envknobs import env_int, env_raw, env_set

    coordinator_address = coordinator_address or env_raw("KEYSTONE_COORDINATOR")
    if num_processes is None and env_set("KEYSTONE_NUM_HOSTS"):
        num_processes = env_int("KEYSTONE_NUM_HOSTS", 0)
    if process_id is None and env_set("KEYSTONE_HOST_ID"):
        process_id = env_int("KEYSTONE_HOST_ID", 0)
    given = {
        "KEYSTONE_COORDINATOR": coordinator_address,
        "KEYSTONE_NUM_HOSTS": num_processes,
        "KEYSTONE_HOST_ID": process_id,
    }
    if any(v is not None for v in given.values()) and any(v is None for v in given.values()):
        missing = sorted(k for k, v in given.items() if v is None)
        raise ValueError(
            f"partial manual-cluster config: {missing} unset — set all of "
            "KEYSTONE_COORDINATOR/KEYSTONE_NUM_HOSTS/KEYSTONE_HOST_ID or none"
        )
    explicit = coordinator_address is not None
    launcher = all(env_set(v) for v in _LAUNCHER_ENV)
    if not (explicit or launcher) or dist.is_initialized():
        return
    world = int(num_processes) if explicit else env_int("WORLD_SIZE", 1)
    rank = int(process_id) if explicit else env_int("RANK", 0)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        if cards == 0:
            backend = "gloo"
        elif cards >= world:
            backend = "nccl"
        else:
            raise ValueError(
                f"{world} ranks share {cards} card(s): NCCL refuses two ranks on one GPU "
                "(Duplicate GPU detected); pass backend='gloo'"
            )
    if backend == "nccl":
        if cards < world:
            raise ValueError(
                f"backend 'nccl' with {world} ranks on {cards} card(s): NCCL refuses two "
                "ranks on one GPU (Duplicate GPU detected); use backend='gloo'"
            )
        torch.cuda.set_device(rank % cards)
    if explicit:
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=address, world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, init_method="env://")


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
    "distributed_init",
    "get_mesh",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_without",
    "model_axis_size",
    "model_mesh",
    "num_devices",
    "require_one_process",
    "row_axes",
    "row_shard_count",
    "same_device",
    "set_mesh",
    "use_mesh",
    "visible_devices",
]
