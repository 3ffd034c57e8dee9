"""Collectives for one controlling process: per-shard lists in lockstep.

Port of ``keystone_tpu/parallel/collectives.py``. In the JAX package a
``shard_map`` body runs once per device and calls ``lax.psum`` and its
kin on a named mesh axis. The port keeps the single controller and makes
the per-device values explicit: a collective takes the list of every
shard's tensor, in mesh (flat, row-major) order, and returns the list of
what each shard holds afterwards. A sharded function is a Python loop
over shards around these calls, as earlier slices turned ``lax.scan``
into Python loops. No thread per shard: the solver mode, cost frames,
spans and tracing frames are thread-local state of the caller.

A collective runs over one mesh axis (or a tuple of axes): the shards
that differ only in those axes form a group, ordered by their linear
index over the axes, and exchange among themselves. Six of them, as the
JAX package has:

==================  ======================================================
``allreduce_sum``   every member gets the group's sum (``psum``)
``all_gather``      every member gets the members' tensors stacked
                    (or concatenated, ``tiled=True``) in group order
``ring_permute``    member i's tensor moves to member i + shift
``reduce_scatter``  the group's sum, split into one tile per member
``all_to_all``      member i's piece j goes to member j, concatenated in
                    member order (the shuffle)
``axis_index``      each shard's position in its group
==================  ======================================================

Determinism: a reduction adds the members' tensors one by one in group
order 0…S−1 on the first member's device and hands every member that one
result, so no result depends on timing. Members on the same device share
the result tensor (treat it as read-only).

Between two cards a collective moves data with peer copies
(``Tensor.to(device, non_blocking=True)``). That path is written but has
run only where every shard lies on one device: it stays unverified until
a machine with several cards runs it. What is missing there is the
machine, not a module.

Across processes (a mesh whose ``replica`` axis is a ``torch.distributed``
group, ``mesh.make_hybrid_mesh`` after ``distributed_init``): a collective
over an axis tuple that holds ``replica`` first runs over the local
shards as above, then crosses processes. ``allreduce_sum`` all-gathers
each process's local sum and adds the parts in rank order (a bare
``all_reduce`` would leave the order to the backend, and a plan would no
longer give the same bits on every run); ``all_gather`` concatenates the
processes' gathers in rank order; ``ring_permute`` is a send/recv pair
per shard whose ring neighbour lives in another process; ``axis_index``
counts the ranks before this one. ``reduce_scatter`` and ``all_to_all``
across processes raise ``ValueError``: no path uses them there. With the
``gloo`` backend the exchange moves host copies, so CUDA shards work on
it too. Every ``torch.distributed`` call counts in :data:`calls`
(``process_all_gather``, ``process_send_recv``).

A shard whose shape differs from its group's, or that does not lie on
its mesh device, raises ``ValueError``: a collective never reshapes or
moves a value to hide a mismatch. :data:`calls` counts each collective's
invocations, the evidence that a sharded path ran.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from .mesh import DATA_AXIS, REPLICA_AXIS, Mesh, get_mesh, same_device

AxisSpec = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a sharded value, as ``jax.sharding.
    PartitionSpec``: each entry is None (replicated), an axis name, or a
    tuple of axis names (sharded over their product, first axis major).
    Mesh axes no entry names are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(d) for d in self) + ")"


P = PartitionSpec


def _axes(axis: AxisSpec) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _groups(mesh: Mesh, axis: AxisSpec) -> List[List[int]]:
    """Flat shard indices grouped by their coordinates on every axis but
    ``axis``; each group ordered by the linear index over ``axis``."""
    axes = _axes(axis)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh {mesh}")
    others = [a for a in mesh.axis_names if a not in axes]
    groups: Dict[tuple, List[Tuple[int, int]]] = {}
    for flat in range(mesh.size):
        coords = mesh.coords(flat)
        key = tuple(coords[a] for a in others)
        pos = 0
        for a in axes:
            pos = pos * mesh.shape[a] + int(coords[a])
        groups.setdefault(key, []).append((pos, flat))
    return [[flat for _pos, flat in sorted(members)] for members in groups.values()]


#: Invocations of each collective in this process, and of each
#: ``torch.distributed`` call a collective made across processes.
calls: Dict[str, int] = dict.fromkeys(
    (
        "allreduce_sum", "all_gather", "ring_permute", "reduce_scatter", "all_to_all",
        "process_all_gather", "process_send_recv",
    ),
    0,
)


def _crosses(mesh: Mesh, axis: AxisSpec, what: str) -> bool:
    """True when the collective over ``axis`` must cross processes: the
    mesh spans processes and ``axis`` holds ``replica``, as its first
    (major) axis."""
    axes = _axes(axis)
    if not mesh.spans_processes or REPLICA_AXIS not in axes:
        return False
    if axes[0] != REPLICA_AXIS:
        raise ValueError(f"{what}: across processes the replica axis must lead {axes}")
    return True


def _host_exchange() -> bool:
    """Whether the process group's backend needs host tensors (gloo)."""
    import torch.distributed as dist

    return dist.get_backend() == "gloo"


def _process_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t``, in rank order, on ``t``'s device."""
    import torch.distributed as dist

    calls["process_all_gather"] += 1
    src = t.detach().to("cpu") if _host_exchange() else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    return [p.to(t.device) for p in parts]


def _validate(xs: Sequence[torch.Tensor], mesh: Mesh, groups: List[List[int]], what: str) -> None:
    calls[what] += 1
    if len(xs) != mesh.size:
        raise ValueError(f"{what}: {len(xs)} shards for a mesh of {mesh.size}")
    for i, (x, device) in enumerate(zip(xs, mesh.flat_devices)):
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{what}: shard {i} is a {type(x).__name__}, not a tensor")
        if not same_device(x.device, device):
            raise ValueError(f"{what}: shard {i} lies on {x.device}, its mesh device is {device}")
    for group in groups:
        shapes = {tuple(xs[i].shape) for i in group}
        dtypes = {xs[i].dtype for i in group}
        if len(shapes) > 1 or len(dtypes) > 1:
            raise ValueError(
                f"{what}: shards {group} disagree in shape or dtype: "
                f"{sorted(shapes)} {sorted(map(str, dtypes))}"
            )


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: itself when it is there, else a copy, made
    asynchronously only towards a card (a non-blocking copy from a card
    into pageable host memory may be read before it lands)."""
    if same_device(x.device, device):
        return x
    return x.to(device, non_blocking=torch.device(device).type == "cuda")


def _ordered_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ parts, added one by one in order on ``device``."""
    acc = _to(parts[0], device).clone()
    for part in parts[1:]:
        acc.add_(_to(part, device))
    return acc


def _fan_out(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``value`` on each of ``devices``, one copy per distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = _to(value, d)
        out.append(copies[d])
    return out


def allreduce_sum(xs: Sequence[torch.Tensor], mesh: Mesh = None, axis: AxisSpec = DATA_AXIS) -> List[torch.Tensor]:
    """``psum``: every member of a group gets the group's sum."""
    mesh = mesh or get_mesh()
    groups = _groups(mesh, axis)
    _validate(xs, mesh, groups, "allreduce_sum")
    cross = _crosses(mesh, axis, "allreduce_sum")
    devices = mesh.flat_devices
    out: List[Any] = [None] * mesh.size
    for group in groups:
        total = _ordered_sum([xs[i] for i in group], devices[group[0]])
        if cross:
            total = _ordered_sum(_process_gather(total), devices[group[0]])
        for i, t in zip(group, _fan_out(total, [devices[i] for i in group])):
            out[i] = t
    return out


def all_gather(
    xs: Sequence[torch.Tensor], mesh: Mesh = None, axis: AxisSpec = DATA_AXIS, tiled: bool = False
) -> List[torch.Tensor]:
    """Every member gets its group's tensors in group order: stacked on a
    new leading axis, or concatenated along axis 0 with ``tiled=True``."""
    mesh = mesh or get_mesh()
    groups = _groups(mesh, axis)
    _validate(xs, mesh, groups, "all_gather")
    cross = _crosses(mesh, axis, "all_gather")
    devices = mesh.flat_devices
    out: List[Any] = [None] * mesh.size
    for group in groups:
        first = devices[group[0]]
        parts = [_to(xs[i], first) for i in group]
        gathered = torch.cat(parts) if tiled else torch.stack(parts)
        if cross:
            gathered = torch.cat(_process_gather(gathered))
        for i, t in zip(group, _fan_out(gathered, [devices[i] for i in group])):
            out[i] = t
    return out


def ring_permute(
    xs: Sequence[torch.Tensor], mesh: Mesh = None, axis: AxisSpec = DATA_AXIS, shift: int = 1
) -> List[torch.Tensor]:
    """Rotate around the ring: member i's tensor goes to member
    (i + shift) mod n (``ppermute`` with that permutation)."""
    mesh = mesh or get_mesh()
    groups = _groups(mesh, axis)
    _validate(xs, mesh, groups, "ring_permute")
    devices = mesh.flat_devices
    if _crosses(mesh, axis, "ring_permute"):
        return _ring_across_processes(xs, mesh, groups, shift)
    out: List[Any] = [None] * mesh.size
    for group in groups:
        n = len(group)
        for pos, i in enumerate(group):
            dst = group[(pos + shift) % n]
            out[dst] = _to(xs[i], devices[dst])
    return out


def _ring_across_processes(xs, mesh: Mesh, groups: List[List[int]], shift: int) -> List[torch.Tensor]:
    """``ring_permute`` over a group that spans processes: the group's
    global position of a local member is rank · n_local + its local
    position; a member whose destination lives in this process moves
    locally, every other one is one ``isend`` / ``irecv`` pair."""
    import torch.distributed as dist

    rank, world = mesh.process_group
    devices = mesh.flat_devices
    host = _host_exchange()
    out: List[Any] = [None] * mesh.size
    ops, landing = [], []
    for group in groups:
        n_local = len(group)
        total = n_local * world
        for pos, i in enumerate(group):
            g = rank * n_local + pos
            dst, src = (g + shift) % total, (g - shift) % total
            if dst // n_local == rank:
                out[group[dst % n_local]] = _to(xs[i], devices[group[dst % n_local]])
            else:
                payload = xs[i].detach().to("cpu") if host else xs[i].contiguous()
                ops.append(dist.P2POp(dist.isend, payload.contiguous(), dst // n_local))
            if src // n_local != rank:
                buf = torch.empty(xs[i].shape, dtype=xs[i].dtype, device="cpu" if host else xs[i].device)
                ops.append(dist.P2POp(dist.irecv, buf, src // n_local))
                landing.append((i, buf))
    if ops:
        calls["process_send_recv"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, buf in landing:
        out[i] = buf.to(devices[i])
    return out


def reduce_scatter(
    xs: Sequence[torch.Tensor], mesh: Mesh = None, axis: AxisSpec = DATA_AXIS, scatter_dimension: int = 0
) -> List[torch.Tensor]:
    """``psum_scatter(tiled=True)``: the group's sum, split along
    ``scatter_dimension`` into one equal tile per member, in group order."""
    mesh = mesh or get_mesh()
    groups = _groups(mesh, axis)
    _validate(xs, mesh, groups, "reduce_scatter")
    if _crosses(mesh, axis, "reduce_scatter"):
        raise ValueError("reduce_scatter across processes: no path of the port uses it")
    devices = mesh.flat_devices
    out: List[Any] = [None] * mesh.size
    for group in groups:
        n = len(group)
        size = xs[group[0]].shape[scatter_dimension]
        if size % n:
            raise ValueError(f"reduce_scatter: dimension {scatter_dimension} of size {size} does not split {n} ways")
        total = _ordered_sum([xs[i] for i in group], devices[group[0]])
        for pos, tile in enumerate(torch.split(total, size // n, dim=scatter_dimension)):
            out[group[pos]] = _to(tile, devices[group[pos]])
    return out


def all_to_all(
    xs: Sequence[torch.Tensor],
    mesh: Mesh = None,
    axis: AxisSpec = DATA_AXIS,
    split_axis: int = 0,
    concat_axis: int = 0,
) -> List[torch.Tensor]:
    """The shard transpose (``all_to_all(tiled=True)``): member i splits
    its tensor along ``split_axis`` into one piece per member; member j
    ends with every member's j-th piece, concatenated along
    ``concat_axis`` in member order."""
    mesh = mesh or get_mesh()
    groups = _groups(mesh, axis)
    _validate(xs, mesh, groups, "all_to_all")
    if _crosses(mesh, axis, "all_to_all"):
        raise ValueError("all_to_all across processes: no path of the port uses it")
    devices = mesh.flat_devices
    out: List[Any] = [None] * mesh.size
    for group in groups:
        n = len(group)
        size = xs[group[0]].shape[split_axis]
        if size % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size {size} does not split {n} ways")
        pieces = [torch.split(xs[i], size // n, dim=split_axis) for i in group]
        for pos_j, j in enumerate(group):
            parts = [_to(pieces[pos_i][pos_j], devices[j]) for pos_i in range(n)]
            out[j] = torch.cat(parts, dim=concat_axis)
    return out


def axis_index(mesh: Mesh = None, axis: AxisSpec = DATA_AXIS) -> List[int]:
    """Each shard's position along ``axis`` (the linear index over a
    tuple of axes, first axis major) — ``lax.axis_index``."""
    mesh = mesh or get_mesh()
    out = [0] * mesh.size
    cross = mesh.spans_processes and REPLICA_AXIS in _axes(axis)
    for group in _groups(mesh, axis):
        for pos, i in enumerate(group):
            out[i] = pos + (mesh.process_group[0] * len(group) if cross else 0)
    return out


def axis_representatives(mesh: Mesh = None, axis: AxisSpec = DATA_AXIS) -> List[int]:
    """One flat shard index per position along ``axis``, in position order:
    the first shard at each position (shards that differ only off
    ``axis`` hold the same piece of a value sharded over it)."""
    mesh = mesh or get_mesh()
    first: Dict[int, int] = {}
    for flat, pos in enumerate(axis_index(mesh, axis)):
        first.setdefault(pos, flat)
    return [first[pos] for pos in sorted(first)]


# ------------------------------------------------------------ sharded values


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return _axes(entry)


def _piece_index(mesh: Mesh, coords: Dict[str, int], axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this shard's piece, number of pieces) of a dimension sharded over
    ``axes``."""
    pos, count = 0, 1
    for a in axes:
        pos = pos * mesh.shape[a] + int(coords[a])
        count *= mesh.shape[a]
    return pos, count


@dataclass
class Sharded:
    """A value laid out over a mesh: ``shards`` holds every shard's tensor
    in mesh order, ``spec`` how the global ``shape`` maps onto them. On
    one device a shard is a view of the global tensor's rows (and
    columns), not a copy."""

    shards: List[torch.Tensor]
    spec: PartitionSpec
    mesh: Mesh
    shape: Tuple[int, ...]

    def assemble(self) -> torch.Tensor:
        """The global tensor, on the first shard's device."""
        pieces: Dict[tuple, torch.Tensor] = {}
        counts = []
        for dim in range(len(self.shape)):
            axes = _dim_axes(self.spec[dim]) if dim < len(self.spec) else ()
            counts.append(math.prod(self.mesh.shape[a] for a in axes))
        device = self.mesh.flat_devices[0]
        for flat, shard in enumerate(self.shards):
            coords = self.mesh.coords(flat)
            key = tuple(
                _piece_index(self.mesh, coords, _dim_axes(self.spec[d]) if d < len(self.spec) else ())[0]
                for d in range(len(self.shape))
            )
            pieces.setdefault(key, shard)

        def build(prefix: tuple, dim: int) -> torch.Tensor:
            if dim == len(self.shape):
                return _to(pieces[prefix], device)
            parts = [build(prefix + (i,), dim + 1) for i in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

        return build((), 0)


def shard_tensor(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> Sharded:
    """Lay ``x`` out over ``mesh`` by ``spec``. Every sharded dimension
    must divide evenly (the ``prepare_*`` functions of ``linalg`` pad
    first). A shard on ``x``'s own device is a view; one on another
    device is a copy of its piece."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more entries than the {x.ndim}-D value")
    cuts = []
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        count = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if x.shape[dim] % count:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split {count} ways")
        cuts.append((axes, x.shape[dim] // count))
    shards = []
    for flat, device in enumerate(mesh.flat_devices):
        coords = mesh.coords(flat)
        view = x
        for dim, (axes, size) in enumerate(cuts):
            if axes:
                pos, _count = _piece_index(mesh, coords, axes)
                view = view.narrow(dim, pos * size, size)
        shards.append(_to(view, device))
    return Sharded(shards, spec, mesh, tuple(x.shape))


def replicated(mesh: Mesh, x: Any) -> Any:
    """``x`` (a tensor, or a tuple / list / dict of them) replicated on
    every shard: a :class:`Sharded` with spec ``P()`` per tensor, one
    copy per distinct device (the broadcast analog)."""
    mesh = mesh or get_mesh()
    from ..utils.tree import tree_map

    return tree_map(lambda a: Sharded(_fan_out(a, mesh.flat_devices), P(), mesh, tuple(a.shape)), x)


def shard_map(
    f: Callable[..., Any],
    mesh: Mesh = None,
    in_specs: Any = None,
    out_specs: Any = None,
) -> Callable[..., Any]:
    """``f`` applied per shard, for a body with no collective inside: the
    returned function lays each global tensor argument out by its entry
    of ``in_specs`` (a :class:`Sharded` argument is taken as it is), calls
    ``f`` once per shard on the local tensors, in shard order, and
    assembles each output by its entry of ``out_specs`` (``P()``: the
    output is replicated, shard 0's is returned)."""
    mesh = mesh or get_mesh()

    def as_tuple(specs, n):
        if isinstance(specs, PartitionSpec):
            return (specs,) * n
        return tuple(specs)

    def run(*args):
        specs = as_tuple(in_specs, len(args))
        laid = [a if isinstance(a, Sharded) else shard_tensor(a, mesh, s) for a, s in zip(args, specs)]
        outs = [f(*(a.shards[i] for a in laid)) for i in range(mesh.size)]
        single = not isinstance(outs[0], tuple)
        per_out = [[o] if single else list(o) for o in outs]
        o_specs = as_tuple(out_specs, len(per_out[0]))
        results = []
        for k, spec in enumerate(o_specs):
            shards = [per_out[i][k] for i in range(mesh.size)]
            if not any(spec):
                results.append(shards[0])
                continue
            shape = list(shards[0].shape)
            for dim, entry in enumerate(spec):
                axes = _dim_axes(entry)
                shape[dim] *= math.prod(mesh.shape[a] for a in axes) if axes else 1
            results.append(Sharded(shards, spec, mesh, tuple(shape)).assemble())
        return results[0] if single else tuple(results)

    return run


__all__ = [
    "P",
    "PartitionSpec",
    "Sharded",
    "all_gather",
    "all_to_all",
    "allreduce_sum",
    "axis_index",
    "axis_representatives",
    "reduce_scatter",
    "replicated",
    "ring_permute",
    "shard_map",
    "shard_tensor",
]
