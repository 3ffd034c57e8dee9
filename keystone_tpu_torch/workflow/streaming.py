"""Streaming chunked execution: overlap ingest, transfer, and compute.

Port of the single-device engine of ``keystone_tpu/workflow/streaming.py``.
The Pipeline API materializes every stage's output dataset, so the full
feature matrix must exist before the solver sees a row. Here:

- :class:`StreamingPlanRule` (the optimizer batch after fusion) rewrites
  eligible ``ingest/featurize-chain → estimator`` graphs: the featurize
  chain between the data source and a ``fit_stream``-capable estimator is
  absorbed into a :class:`StreamingFitOperator` that consumes the RAW
  dataset directly.
- At fit time the operator drives a chunked plan (:class:`ChunkStream`):
  a bounded-prefetch host pipeline
  (:class:`~keystone_tpu_torch.data.ingest.PrefetchQueue`) whose workers
  fetch a window (``Dataset.fetch_rows``), narrow it to its transfer
  dtype (uint8 stays uint8) and zero-pad the tail chunk, then copy it
  into PINNED host memory; the main loop issues the ``non_blocking``
  host→device copies on a dedicated copy stream, and the compute stream
  waits on that upload's event, casts on the device, runs the featurize
  chain and the estimator's in-place accumulation step
  (``linalg.gram_stream_step``) — the full feature matrix never exists,
  only O(chunk) host buffers and O(d²) device statistics.
- A CUDA-resident ``ArrayDataset`` streams by device slicing: nothing
  crosses the host link and ``bytes_transferred`` stays 0.

Buffer lifetimes on the card. A pinned host buffer is dropped as soon as
its copy is issued: PyTorch's caching host allocator holds the block
until the copy's event completes, so no worker can reuse it while the
copy is in flight. Device tensors filled on the copy stream are marked
with ``record_stream`` for the compute stream that reads them, so the
caching allocator cannot hand their memory out before that compute ends.

Overlap. On the card the loop stages two chunks ahead
(``stream_pipelined(prefetch=2)``): chunk i+1's copy is issued before
chunk i's compute, so the copy engine moves chunk i+1 while the SMs work
on chunk i even when the host pipeline, not the device, sets the pace.
:meth:`StreamReport.overlap_ok` reads the host clock as in the JAX
package; ``StreamReport.device_overlap_ok`` reads CUDA events recorded
on the two streams and says whether each chunk's copy started on the
card before the previous chunk's compute ended there. On the CPU the
loop stages one chunk ahead, as the JAX package does, and the hand-off
to the device is a zero-copy ``torch.from_numpy``.

Durable fits (``reliability/durable.py``). With a checkpoint store on
``PipelineEnv``, :class:`StreamingFitOperator` arms a
:class:`~keystone_tpu_torch.reliability.durable.DurableFold` on the
stream: every ``ckpt_every`` dispatched chunks the fold copies its carry
to the host — a synchronisation point, timed into
``StreamReport.checkpoint_s`` — and commits it with a cursor before the
next chunk may update it in place. A fresh process that finds a valid
resume entry seeds the fold from its state and skips the chunks before
its cursor (``resumed_from_chunk``, ``reingested_chunks``); a completed
fold retires the entry.

Scheduler leases (``sched/scheduler.py``). A scheduled caller (the
refit daemon under a ``MeshScheduler``) arms ``ChunkStream.lease``; the
fold consults :meth:`Lease.should_yield` at every chunk boundary, and on
sustained serving pressure it commits its durable cursor, marks
``StreamReport.preempted_at_chunk`` and returns the prefix carry
(:class:`FoldPreempted` is raised and caught inside the fold), so the
deferred fold resumes from the cursor, not from row zero.

A completed, unresumed fold reports its rows/s to the cost observatory.
Unlike the JAX package's fold it records no ``stream:<chain>:…``
observation in the profile store: a store write costs ~12 ms on the
host, as much as a small refit fold. ``tune`` measures and records
those entries, which ``MeasuredKnobRule`` replays.

Partitioned chunk plans (``parallel/partitioner.py``). With an eligible
partition decision pinned by the optimizer's partition batch, the fold
runs the sharded plan of the JAX package: ``chunk_rows`` is rounded up to
a row-shard multiple, every chunk is split into row shards (views on the
chunk's device), each shard featurizes its slice and accumulates into its
OWN partial carry — no collective per chunk — and the partials are
reduced once at finish, summed over the row shards in shard order. In a
2-D layout (``model_shards`` > 1) each carry block holds one feature
block of the statistics through the step's blocked protocol
(``model_layout`` / ``model_block_step``) and the finish concatenates the
blocks; a step without the protocol, or a featurized width the model
shards do not divide or that is below the width floor, demotes the plan
to row-only (``demote_model_axis``). The report's ``shards``,
``model_shards``, ``mesh_shape``, per-axis ``collective_bytes`` and
``state_bytes_per_device`` are the JAX package's plan-pure numbers.

Under a sharded plan the fold is durable and elastic, as the JAX
package's. A commit merges the per-shard partials (rows summed, feature
blocks reassembled) into one mesh-independent snapshot, so a checkpoint
resumes on any mesh, one device included. The ``parallel.shard_loss``
probe runs once per sharded chunk dispatch; a fault there is a
:class:`~keystone_tpu_torch.reliability.durable.ShardLossError`, which the
fold absorbs (``_salvage_shard_loss``): the surviving row groups'
partials merge (a loss on either axis of a 2-D layout drops its whole
row group), the seed is added back when row group 0 was lost, the lost
rows of every chunk dispatched in the attempt are re-ingested ahead of
the remainder, and the plan is re-decided on ``mesh_without(...)`` —
single-device when the partitioner says so. Commits are suspended for
the rest of a fold that lost a shard: recovery windows break the chunk
prefix a cursor describes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import (
    ArrayDataset,
    Dataset,
    ObjectDataset,
    default_ingest_workers,
    transfer_dtype,
)
from ..data.ingest import PrefetchQueue
from ..device import DeviceLike, resolve_device
from ..envknobs import env_disabled, env_int
from ..obs import cost as _cost
from ..obs import names as _names
from ..obs import spans as _spans
from ..reliability.faultinject import probe
from ..utils.tree import tree_leaves, tree_map
from .graph import Graph, NodeId, SourceId
from .operators import DatasetOperator, EstimatorOperator, TransformerOperator
from .rules import PrefixMap, Rule

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------ enablement

# Tri-state like fusion's: None → env default (on unless
# KEYSTONE_STREAMING=off/0/disabled).
_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def streaming_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return not env_disabled("KEYSTONE_STREAMING")


def set_streaming_enabled(value: Optional[bool]) -> None:
    """Force streaming on/off process-wide; ``None`` restores the env
    default."""
    global _enabled
    with _enabled_lock:
        _enabled = value


@contextmanager
def streaming_disabled():
    """Scoped off-switch (parity checks build the materialized reference
    here, exactly like ``fusion_disabled()``)."""
    global _enabled
    with _enabled_lock:
        prev = _enabled
        _enabled = False
    try:
        yield
    finally:
        with _enabled_lock:
            _enabled = prev


def stream_chunk_rows() -> int:
    """Rows per streamed chunk (``KEYSTONE_STREAM_CHUNK_ROWS``, default
    4096 — large enough to amortize dispatch, small enough that two host
    chunk buffers stay far below any realistic feature matrix)."""
    return max(1, env_int("KEYSTONE_STREAM_CHUNK_ROWS", 4096))


def stream_min_rows() -> int:
    """Plan-time eligibility floor for known-size datasets: below
    max(2·chunk, this) the materialized path wins.
    ``KEYSTONE_STREAM_MIN_ROWS`` raises it."""
    return env_int("KEYSTONE_STREAM_MIN_ROWS", 0)


def stream_prefetch_depth() -> int:
    """Host prefetch-queue depth (``KEYSTONE_STREAM_PREFETCH``, default
    1): chunks prepared ahead of the one in hand."""
    return max(1, env_int("KEYSTONE_STREAM_PREFETCH", 1))


def chain_class(members: Sequence[Any]) -> str:
    """Process-stable identity of a featurize chain: the member type
    sequence, hashed. Deliberately coarser than a content digest — the
    resume key names the logical fit with it, and KV306 then rules on
    the contents."""
    import hashlib

    token = "|".join(f"{type(m).__module__}.{type(m).__qualname__}" for m in members)
    return hashlib.sha1(token.encode()).hexdigest()[:16]


class FoldPreempted(Exception):
    """Raised inside ``ChunkStream.fold``'s dispatch loop when the armed
    scheduler lease yields at a chunk boundary (sustained serving
    pressure). Caught by the fold itself — it returns normally with the
    prefix carry and ``report.preempted_at_chunk`` set; the durable
    cursor was committed before the raise, so the deferred fold resumes
    from the boundary instead of restarting."""

    def __init__(self, chunk_index: int):
        self.chunk_index = int(chunk_index)
        super().__init__(f"fold preempted at chunk {chunk_index}")


class StreamingFallback(Exception):
    """Raised (internally, before any chunk is consumed) when a planned
    streaming fit turns out ineligible at run time — an unchunkable
    dataset, no labels, labels of the wrong rank, or a chain that does
    not end in one matrix. The operator then takes the materialized path.
    Never used for any other failure: those propagate."""


@dataclass(frozen=True)
class ChunkSpec:
    """Shape and dtype of one chunk leaf (the counterpart of a JAX
    ``ShapeDtypeStruct``; a leaf, not a container, to the tree utils)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


# ------------------------------------------------------------- pipelined loop


def stream_pipelined(
    items: Iterable[Any],
    stage: Callable[[Any], Any],
    compute: Callable[[Any, Any], Any],
    consume: Callable[[Any, Any], None],
    prefetch: int = 2,
) -> int:
    """The shared double-buffered dispatch loop.

    ``stage(item)`` issues the (async) host→device upload; ``compute``
    dispatches device work on the staged value; ``consume`` waits for and
    drains a result ONE item behind the dispatch frontier — so staging of
    item i+1 is always issued before the loop blocks on item i, and
    transfer, device compute and host work overlap. ``prefetch`` items
    are staged ahead of the one being computed. Returns the number of
    items processed.
    """
    staged: List[Tuple[Any, Any]] = []
    pending: List[Tuple[Any, Any]] = []
    it = iter(items)
    done = 0

    def stage_next() -> bool:
        try:
            item = next(it)
        except StopIteration:
            return False
        staged.append((stage(item), item))
        return True

    for _ in range(max(1, prefetch)):
        stage_next()
    while staged:
        s, item = staged.pop(0)
        pending.append((compute(s, item), item))
        stage_next()
        if len(pending) > 1:
            r, r_item = pending.pop(0)
            consume(r, r_item)
            done += 1
    while pending:
        r, r_item = pending.pop(0)
        consume(r, r_item)
        done += 1
    return done


# ------------------------------------------------------------------- reporting


@dataclass
class StreamReport:
    """What the last streaming fit actually did — the evidence the smoke
    script and tests assert on (overlap, first applications, memory,
    durable commits).

    The partition fields are the JAX package's: row and model shards,
    mesh shape, the finish reduction's payload bytes per mesh axis
    (``collective_bytes_data`` / ``_model``, their sum
    ``collective_bytes``) and the bytes of streamed state one shard
    holds (``state_bytes_per_device``); 1 / () / 0 single-device."""

    chunks: int = 0
    chunk_rows: int = 0
    num_examples: int = 0
    bytes_transferred: int = 0
    prefetch_depth: int = 0
    host_buffer_peak_bytes: int = 0
    stall_s: float = 0.0
    #: First applications of the chunk step at a new chunk shape: after
    #: the first chunk, and since then (0 when every chunk, the padded
    #: tail included, has the first chunk's shape).
    compiles_first_chunk: int = 0
    compiles_steady_state: int = 0
    shards: int = 1
    model_shards: int = 1
    mesh_shape: Tuple[int, ...] = ()
    collective_bytes: int = 0
    collective_bytes_data: int = 0
    collective_bytes_model: int = 0
    state_bytes_per_device: int = 0
    checkpoints: int = 0
    resumed_from_chunk: Optional[int] = None
    reingested_chunks: int = 0
    shard_losses: int = 0
    preempted_at_chunk: Optional[int] = None
    #: Per durable commit: seconds from the carry's device→host copy to
    #: the store's rename (the fold waits for it), and bytes written.
    checkpoint_s: List[float] = field(default_factory=list)
    checkpoint_bytes: List[int] = field(default_factory=list)
    #: perf_counter at fold start — the event lists below are offsets
    #: from this.
    t0_s: float = 0.0
    upload_issued_t: List[float] = field(default_factory=list)
    dispatch_t: List[float] = field(default_factory=list)
    compute_done_t: List[float] = field(default_factory=list)
    #: On the card: True when every chunk's host→device copy started
    #: before the previous chunk's compute ended, by CUDA events on the
    #: copy and compute streams. None on the CPU, or when nothing crossed
    #: the host link (a CUDA-resident dataset).
    device_overlap_ok: Optional[bool] = None
    #: Per-chunk device milliseconds of the copy and of the compute
    #: (CUDA events; empty on the CPU).
    device_copy_ms: List[float] = field(default_factory=list)
    device_compute_ms: List[float] = field(default_factory=list)

    def overlap_ok(self) -> bool:
        """True when the upload of chunk i+1 was issued before compute of
        chunk i was observed complete (host clock) — the double-buffer
        invariant of the dispatch loop."""
        if self.chunks < 2:
            return True
        return all(
            self.upload_issued_t[i + 1] <= self.compute_done_t[i]
            for i in range(self.chunks - 1)
        )


_last_report: Optional[StreamReport] = None
_report_lock = threading.Lock()


def last_stream_report() -> Optional[StreamReport]:
    """The :class:`StreamReport` of the most recent streaming fit in this
    process (None if none ran)."""
    return _last_report


def _publish_report(report: StreamReport) -> None:
    global _last_report
    with _report_lock:
        _last_report = report
    _names.metric(_names.STREAM_HOST_BUFFER_PEAK).set(report.host_buffer_peak_bytes)


# ----------------------------------------------------------- the chunk step


def _cast_tree(x):
    """uint8/int/bool leaves → float32 ON THE DEVICE; floats unchanged."""
    return tree_map(lambda a: a if a.is_floating_point() else a.to(torch.float32), x)


def _apply_chain(members, x, mask):
    """Cast → featurize chain → re-zero of pad rows. Re-zeroing once at
    the end is valid because ``apply_arrays`` is row-independent (the
    BatchTransformer contract), so the estimator's accumulation sees
    exact zeros — a member such as a shift makes zero rows non-zero."""
    x = _cast_tree(x)
    for m in members:
        x = m.apply_arrays(x)
    real = mask.reshape(-1) > 0

    def zero_pad(a):
        keep = real.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))

    return tree_map(zero_pad, x)


class _StepRecord:
    """The chunk signatures a (members, step) pair has been applied at:
    ``traces`` grows by one at the first application at each new chunk
    shape — the JAX package's trace counter, for a step that is not
    traced."""

    def __init__(self, members: tuple, step_fn: Callable):
        self.members = members  # strong refs: the cache key holds their ids
        self.step_fn = step_fn
        self.traces: List[tuple] = []
        self._seen: set = set()
        self._lock = threading.Lock()

    def note(self, chunk: Any) -> None:
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in tree_leaves(chunk))
        with self._lock:
            if sig not in self._seen:
                self._seen.add(sig)
                self.traces.append(sig)


# One record per (member instances, step_fn) pair, shared across folds:
# every fit of an unfitted pipeline builds a fresh StreamingFitOperator
# over the same members, and a re-fit must read as "no new chunk shape".
# Bounded LRU; entries keep strong refs to their members.
_STEP_RECORDS: "OrderedDict[tuple, _StepRecord]" = OrderedDict()
_STEP_RECORDS_MAX = 32
_step_lock = threading.Lock()


def _shared_step_record(members: tuple, step_fn: Callable, partition=None) -> _StepRecord:
    key = tuple(id(m) for m in members) + (id(step_fn),)
    if partition is not None:
        key += ("sharded", id(partition.mesh), partition.shards, partition.model_shards)
    with _step_lock:
        record = _STEP_RECORDS.get(key)
        if record is None:
            record = _STEP_RECORDS[key] = _StepRecord(members, step_fn)
            while len(_STEP_RECORDS) > _STEP_RECORDS_MAX:
                _STEP_RECORDS.popitem(last=False)
        _STEP_RECORDS.move_to_end(key)
        return record


# ------------------------------------------------------------------ the stream


def _host_nbytes(tree) -> int:
    """Bytes of the host leaves of ``tree`` (numpy arrays and CPU
    tensors, pinned or not); device leaves count 0."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, np.ndarray):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu":
            total += leaf.numel() * leaf.element_size()
    return total


def _tree_nbytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _labels_host(labels: Dataset, device: torch.device):
    """Labels as one (n, k) matrix, sliced per chunk by the engine: a host
    numpy array at its transfer dtype for host labels (each chunk's rows
    are uploaded with the chunk), or a tensor on ``device`` for labels
    already on a card (each chunk's rows are a device slice: no label
    ever makes a per-chunk device→host trip). Labels are O(n·k) — the
    feature matrix is what never materializes."""
    if isinstance(labels, ObjectDataset):
        y = labels.fetch_rows(0, len(labels))
    elif isinstance(labels, ArrayDataset) and isinstance(labels.data, torch.Tensor):
        y = labels.data[: labels.num_examples]
        if y.device.type == "cpu" or device.type == "cpu":
            # Host labels, or a CPU fit: no card in the copy.  # keystone: allow-sync
            y = y.cpu().numpy()
        else:
            y = y.to(device)
    else:
        raise StreamingFallback(f"labels of type {type(labels).__name__}")
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim != 2:
        raise StreamingFallback(f"labels must be rank ≤ 2, got {tuple(y.shape)}")
    if isinstance(y, np.ndarray):
        return np.ascontiguousarray(y.astype(transfer_dtype(y.dtype), copy=False))
    return y


def _chunk_spec(data: Dataset, chunk_rows: int):
    """Specs of one padded chunk as the device receives it: host leaves
    at their transfer dtype, device leaves at their own."""

    def spec(leaf) -> ChunkSpec:
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            return ChunkSpec((chunk_rows,) + tuple(leaf.shape[1:]), leaf.dtype)
        # A host leaf (a card leaf returned above).  # keystone: allow-sync
        arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype == object:
            raise StreamingFallback(f"{type(data).__name__} of non-array records is not chunkable")
        return ChunkSpec((chunk_rows,) + arr.shape[1:], _torch_dtype(transfer_dtype(arr.dtype)))

    if isinstance(data, ArrayDataset):
        return tree_map(spec, data.data)
    if isinstance(data, ObjectDataset):
        if not len(data):
            raise StreamingFallback("empty dataset")
        # Plan-time probe on ONE stacked host item, before any chunk flows.
        return tree_map(spec, data.fetch_rows(0, 1))
    raise StreamingFallback(f"{type(data).__name__} is not chunkable")


def _pad_narrow(a: np.ndarray, chunk_rows: int) -> np.ndarray:
    """Narrow a host leaf to its transfer dtype and zero-pad the tail
    chunk to the chunk shape (one shape for every chunk)."""
    narrow = transfer_dtype(a.dtype)
    if narrow != a.dtype:
        a = a.astype(narrow)
    rows = a.shape[0]
    if rows < chunk_rows:
        a = np.concatenate([a, np.zeros((chunk_rows - rows,) + a.shape[1:], a.dtype)])
    return np.ascontiguousarray(a)


def _pad_rows(a: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """Zero-pad a device leaf's leading axis to ``chunk_rows``."""
    rows = a.shape[0]
    if rows == chunk_rows:
        return a
    return torch.cat([a, a.new_zeros((chunk_rows - rows,) + tuple(a.shape[1:]))])


def _pinned(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` in page-locked host memory (the source a
    ``non_blocking`` copy needs to run on the copy engine)."""
    out = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
    out.copy_(torch.from_numpy(a))
    return out


def _carry_layout(step_fn, carry) -> Optional[Tuple[Optional[int], ...]]:
    """The blocked-carry protocol's per-leaf feature axes, checked against
    the carry — None when the step declares no protocol or it does not
    match the carry's leaves."""
    layout = getattr(step_fn, "model_layout", None)
    if layout is None or getattr(step_fn, "model_block_step", None) is None:
        return None
    if len(tree_leaves(carry)) != len(layout):
        return None
    return tuple(layout)


class _ShardedCarry:
    """The per-shard partial carries of a partitioned fold: one carry per
    block (row shard i, model shard j), block index i·model_shards + j,
    each on the device of the mesh shard at those coordinates (model
    coordinate 0 for a row-only plan on a 2-D mesh). Block 0 (and, for
    feature leaves, blocks 0…model_shards−1 of data row 0) holds the
    estimator's seed carry; every other block starts at zero — exact for
    the additive accumulation the fit_stream protocol is."""

    def __init__(self, part, step_fn, carry):
        from ..parallel.collectives import axis_index
        from ..parallel.mesh import MODEL_AXIS

        mesh = part.mesh
        self.p_d, self.p_m = part.shards, part.model_shards
        self.layout = _carry_layout(step_fn, carry) if self.p_m > 1 else None
        row_of = axis_index(mesh, part.mesh_axes)
        model_of = axis_index(mesh, MODEL_AXIS) if MODEL_AXIS in mesh.shape else [0] * mesh.size
        self.devices: List[Any] = [None] * (self.p_d * self.p_m)
        for flat, device in enumerate(mesh.flat_devices):
            j = model_of[flat]
            if self.p_m == 1 and j != 0:
                continue
            self.devices[row_of[flat] * self.p_m + j] = device
        leaves = tree_leaves(carry)
        layout = self.layout or (None,) * len(leaves)

        def block(b: int):
            i, j = divmod(b, self.p_m)
            out = []
            for leaf, ax in zip(leaves, layout):
                if ax is None or self.p_m == 1:
                    part_leaf = leaf
                else:
                    width = leaf.shape[ax] // self.p_m
                    part_leaf = leaf.narrow(ax, j * width, width)
                seeded = i == 0 and (j == 0 or (ax is not None and self.p_m > 1))
                dev = self.devices[b]
                out.append(part_leaf.to(dev, copy=True) if seeded else torch.zeros_like(part_leaf, device=dev))
            return tuple(out)

        self.blocks = [block(b) for b in range(self.p_d * self.p_m)]

    def merge(self, device: torch.device, drop_row: Optional[int] = None):
        """THE finish reduction: per leaf, the partials summed over the row
        shards in shard order; feature leaves then concatenate their model
        blocks along the layout axis, feature-free leaves sum them.
        ``drop_row`` leaves one row group out (a shard loss's salvage)."""
        from ..parallel.collectives import _ordered_sum

        layout = self.layout or (None,) * len(self.blocks[0])
        rows = [i for i in range(self.p_d) if i != drop_row]
        out = []
        for k, ax in enumerate(layout):
            cols = [
                _ordered_sum([self.blocks[i * self.p_m + j][k] for i in rows], device)
                if rows
                else torch.zeros_like(self.blocks[j][k], device=device)
                for j in range(self.p_m)
            ]
            if self.p_m == 1:
                out.append(cols[0])
            elif ax is None:
                out.append(_ordered_sum(cols, device))
            else:
                out.append(torch.cat(cols, dim=ax))
        return tuple(out)


class ChunkStream:
    """The engine-side handle handed to ``Estimator.fit_stream``.

    ``fold(init_fn, step_fn)`` drives the chunked plan on ``device``
    (default CUDA):

    - ``init_fn(feat_spec, y_spec)`` receives :class:`ChunkSpec` trees of
      the FEATURIZED chunk (:meth:`feature_aval`) and of the label chunk,
      and returns the initial carry on ``device``. Raise
      :class:`StreamingFallback` there to reject the shape (nothing has
      been prefetched yet).
    - ``step_fn(carry, x_feat, y) -> carry`` runs after the featurize
      chain on every chunk and accumulates into the carry in place. A
      step with ``needs_mask = True`` is called as
      ``step_fn(carry, x_feat, y, mask)``: ``mask`` is (rows, 1) float32
      holding each row's absolute dataset index + 1, 0 for pad rows.

    Returns ``(carry, info)`` where info has ``num_examples``, ``chunks``
    and the :class:`StreamReport`.
    """

    def __init__(
        self,
        data: Dataset,
        labels: Optional[Dataset],
        members: Sequence[TransformerOperator],
        chunk_rows: Optional[int] = None,
        prefetch: Optional[int] = None,
        workers: Optional[int] = None,
        device: DeviceLike = None,
        partition=None,
    ):
        self.data = data
        self.labels = labels
        self.members = tuple(members)
        self.chunk_rows = chunk_rows or stream_chunk_rows()
        # An eligible PartitionDecision runs the sharded chunk plan: the
        # chunk must divide evenly across the row shards.
        self.partition = partition if partition is not None and getattr(partition, "eligible", False) else None
        if self.partition is not None:
            s = self.partition.shards
            self.chunk_rows = -(-self.chunk_rows // s) * s
        self.prefetch = prefetch or stream_prefetch_depth()
        self.workers = workers or min(default_ingest_workers(), 4)
        self.device = resolve_device(device)
        self.num_examples = len(data)
        self._feat_aval = None
        #: Durability plan (reliability/durable.py DurableFold), armed by
        #: the streaming operator when a checkpoint store is attached.
        #: None = the fold without checkpoints.
        self.durable = None
        #: Mesh-scheduler lease (sched/scheduler.py), armed by scheduled
        #: callers: consulted at every chunk boundary; sustained pressure
        #: preempts the fold there, committing the durable cursor first.
        #: None = an unscheduled fold.
        self.lease = None

    def feature_aval(self):
        """Specs of one FEATURIZED chunk: the chain run on a zero batch of
        one row on the stream's device (a few tiny launches; the chain is
        row-independent, so the row count is the only thing that
        differs). Raises :class:`StreamingFallback` when the dataset is
        not chunkable; an exception from the chain itself propagates."""
        if self._feat_aval is None:
            spec = _chunk_spec(self.data, self.chunk_rows)
            one_row = tree_map(
                lambda s: torch.zeros((1,) + tuple(s.shape[1:]), dtype=s.dtype, device=self.device),
                spec,
            )
            mask = torch.ones((1, 1), device=self.device)
            out = _apply_chain(self.members, one_row, mask)
            self._feat_aval = tree_map(
                lambda a: ChunkSpec((self.chunk_rows,) + tuple(a.shape[1:]), a.dtype), out
            )
        return self._feat_aval

    # ---------------------------------------------------------------- fold
    def fold(self, init_fn, step_fn):
        from ..reliability.durable import ShardLossError, shard_loss_index

        data, chunk_rows, n, device = self.data, self.chunk_rows, self.num_examples, self.device
        if self.labels is None:
            raise StreamingFallback("no labels bound for a supervised fit")
        y_all = _labels_host(self.labels, device)
        if y_all.shape[0] < n:
            raise StreamingFallback(f"labels rows {y_all.shape[0]} < data rows {n}")
        feat_spec = self.feature_aval()
        y_dtype = (
            _torch_dtype(y_all.dtype) if isinstance(y_all, np.ndarray) else y_all.dtype
        )
        carry = init_fn(feat_spec, ChunkSpec((chunk_rows, y_all.shape[1]), y_dtype))
        if type(data).fetch_rows is Dataset.fetch_rows:
            raise StreamingFallback(f"{type(data).__name__} is not chunkable")
        part = self.partition
        if part is not None and part.model_shards > 1:
            # The plan granted the model axis on the raw width; re-check it
            # against the estimator's real carry and the step's protocol.
            part = self._validate_model_axis(part, step_fn, carry)
        sharded = _ShardedCarry(part, step_fn, carry) if part is not None else None
        # Shard-loss salvage re-adds the fold's seed when row group 0 is
        # lost: the blocks are copies, so ``carry`` stays the seed.
        attempt_seed = carry

        record = _shared_step_record(self.members, step_fn, part)
        members = self.members
        # Index-keyed folds (sketch/core.py) declare needs_mask: the step
        # receives the chunk's pad mask — whose lane holds absolute row
        # indices — as a fourth argument. Gram steps keep three.
        needs_mask = bool(getattr(step_fn, "needs_mask", False))
        windows = [(s, min(s + chunk_rows, n)) for s in range(0, n, chunk_rows)]
        durable = self.durable
        start_chunk = min(durable.start_chunk, len(windows)) if durable is not None else 0
        report = StreamReport(
            chunk_rows=chunk_rows,
            num_examples=n,
            prefetch_depth=self.prefetch,
            shards=part.shards if part is not None else 1,
            model_shards=part.model_shards if part is not None else 1,
            mesh_shape=tuple(part.mesh_shape) if part is not None else (),
            # Bytes of streamed state ONE shard holds: falls with the
            # model shards of a 2-D plan, whole in a row-only one.
            state_bytes_per_device=_tree_nbytes(sharded.blocks[0] if sharded is not None else carry),
        )
        if start_chunk:
            # Crash-resume: chunks before the cursor live in the seeded
            # carry already — only the suffix is re-ingested.
            report.resumed_from_chunk = start_chunk
            report.reingested_chunks = len(windows) - start_chunk
            _names.metric(_names.DURABLE_REINGESTED_CHUNKS).inc(report.reingested_chunks)
        # Chunks dispatched in this ATTEMPT (a shard loss starts a new one
        # over its recovery windows), and ABSOLUTE logical rows dispatched
        # (a resumed fold starts at the cursor's count): what a committed
        # cursor records. ``folded_log`` keeps each dispatched window's
        # geometry, so a salvage can slice the lost shard's rows back out.
        # Commits stop after a loss.
        progress = {
            "dispatched": 0, "committed": 0,
            "rows": durable.resume_rows if durable is not None else 0,
            "suspended": False,
        }
        folded_log: List[Tuple[int, int, int, int]] = []
        attempt_windows: List[Tuple[int, int]] = windows[start_chunk:]
        lease = self.lease
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None
        compute_stream = torch.cuda.current_stream(device) if cuda else None
        # CUDA events per chunk: copy start/end on the copy stream,
        # compute start/end on the compute stream.
        events: List[Tuple[Any, Any, Any, Any]] = []
        chunks_c = _names.metric(_names.STREAM_CHUNKS)
        bytes_c = _names.metric(_names.STREAM_BYTES)
        host_y = isinstance(y_all, np.ndarray)

        def prepare(window):
            # Runs in the prefetch workers: the fetch/stack, narrowing and
            # pinned copy overlap the device work of earlier chunks.
            start, stop = window
            rows = stop - start
            x = data.fetch_rows(start, stop)
            x = tree_map(lambda a: _pad_narrow(a, chunk_rows) if isinstance(a, np.ndarray) else a, x)
            y = _pad_narrow(y_all[start:stop], chunk_rows) if host_y else None
            mask = None
            if any(isinstance(a, np.ndarray) for a in tree_leaves(x)):
                # The mask lane carries each row's absolute index + 1
                # (0 = pad); the chain only tests > 0. Exact in float32
                # up to 2^24 rows.
                mask = np.zeros((chunk_rows, 1), np.float32)
                mask[:rows, 0] = np.arange(start + 1, stop + 1, dtype=np.float32)
            if cuda:
                x = tree_map(lambda a: _pinned(a) if isinstance(a, np.ndarray) else a, x)
                y = _pinned(y) if y is not None else None
                mask = _pinned(mask) if mask is not None else None
            # A list, so that ``stage`` can take the host buffers out of it:
            # the dispatch loop keeps each item until it is consumed.
            return [x, y, mask, window]

        in_hand_peak = 0
        t0 = time.perf_counter()
        report.t0_s = t0

        def stage(chunk):
            nonlocal in_hand_peak
            x, y, mask, (start, stop) = chunk
            chunk[:3] = (None, None, None)
            nbytes = _host_nbytes((x, y, mask))
            in_hand_peak = max(in_hand_peak, nbytes)
            report.upload_issued_t.append(time.perf_counter() - t0)
            moved: List[torch.Tensor] = []
            copy_start = uploaded = None
            if cuda:

                def upload(a):
                    if a is None or a.device.type != "cpu":
                        return a
                    out = a.to(device, non_blocking=True)
                    moved.append(out)
                    return out

                copy_start = torch.cuda.Event(enable_timing=True)
                uploaded = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(copy_stream):
                    copy_start.record()
                    x, y, mask = tree_map(upload, x), upload(y), upload(mask)
                    uploaded.record()
            else:

                def as_tensor(a):
                    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a

                x, y, mask = tree_map(as_tensor, x), as_tensor(y), as_tensor(mask)
            # Device-resident leaves: pad, slice and build on the compute
            # stream that reads them.
            x = tree_map(lambda a: _pad_rows(a, chunk_rows), x)
            if y is None:
                y = _pad_rows(y_all[start:stop], chunk_rows)
            if mask is None:
                mask = torch.zeros((chunk_rows, 1), dtype=torch.float32, device=device)
                mask[: stop - start, 0] = torch.arange(
                    start + 1, stop + 1, dtype=torch.float32, device=device
                )
            report.bytes_transferred += nbytes
            bytes_c.inc(nbytes)
            return x, y, mask, moved, copy_start, uploaded

        def sharded_step(x, y, mask):
            # Each row shard featurizes its slice of the chunk (once per
            # device) and accumulates into its own carry block(s).
            from ..parallel.collectives import _to

            rps = chunk_rows // sharded.p_d
            block_step = getattr(step_fn, "model_block_step", None)
            slices = {}
            for b, dev in enumerate(sharded.devices):
                i, j = divmod(b, sharded.p_m)
                if (i, dev) not in slices:
                    rows = slice(i * rps, (i + 1) * rps)
                    mi = _to(mask[rows], dev)
                    xi = tree_map(lambda a: _to(a[rows], dev), x)
                    slices[(i, dev)] = (_apply_chain(members, xi, mi), _to(y[rows], dev), mi)
                feats, yi, mi = slices[(i, dev)]
                c = sharded.blocks[b]
                if sharded.p_m > 1:
                    c = block_step(c, feats, yi, mi, j) if needs_mask else block_step(c, feats, yi, j)
                elif needs_mask:
                    c = step_fn(c, feats, yi, mi)
                else:
                    c = step_fn(c, feats, yi)
                sharded.blocks[b] = c

        def commit_checkpoint():
            # Commit-before-continue barrier: the carry's device→host copy
            # waits for every chunk dispatched so far, and the atomic
            # store write completes BEFORE the next chunk updates the
            # carry in place — a persisted carry is never stale.
            t_commit = time.perf_counter()
            if sharded is not None:
                # The per-shard partials merged (on the stream's device)
                # into a mesh-independent snapshot: resume may re-plan on
                # any mesh.
                leaves = sharded.merge(self.device)
            else:
                leaves = tree_leaves(carry)
            host = tuple(a.detach().to("cpu", copy=True).numpy() for a in leaves)
            ok = durable.commit(
                host,
                chunk_index=start_chunk + progress["dispatched"],
                rows_consumed=progress["rows"],
                chunk_rows=chunk_rows,
                mesh_shape=tuple(part.mesh_shape) if sharded is not None else (),
                shards=part.shards if sharded is not None else 1,
                model_shards=part.model_shards if sharded is not None else 1,
            )
            progress["committed"] = progress["dispatched"]
            if ok:
                report.checkpoints += 1
                report.checkpoint_s.append(time.perf_counter() - t_commit)
                report.checkpoint_bytes.append(durable.store.last_write_bytes)

        def compute(staged, chunk):
            nonlocal carry
            x, y, mask, moved, copy_start, uploaded = staged
            done_chunks = progress["dispatched"]
            if lease is not None and done_chunks > 0 and lease.should_yield():
                # Preempt at the chunk boundary: commit the durable cursor
                # FIRST (a deferred fold resumes from here), then unwind
                # with the prefix carry, which stays valid statistics.
                if durable is not None and not progress["suspended"] and progress["committed"] != done_chunks:
                    commit_checkpoint()
                report.preempted_at_chunk = start_chunk + done_chunks
                lease.mark_preempted(start_chunk + done_chunks)
                raise FoldPreempted(start_chunk + done_chunks)
            if (
                durable is not None
                and durable.ckpt_every > 0
                and not progress["suspended"]
                and done_chunks > 0
                and done_chunks % durable.ckpt_every == 0
            ):
                commit_checkpoint()
            if sharded is not None:
                try:
                    probe("parallel.shard_loss")
                except Exception as exc:
                    # Any fault at this site models the runtime observing a
                    # shard gone before this chunk could dispatch; indexed
                    # over ALL carry blocks (row × model, flat row-major).
                    raise ShardLossError(
                        shard_loss_index(part.total_shards), start_chunk + done_chunks, part.total_shards
                    ) from exc
            probe("streaming.chunk")
            report.dispatch_t.append(time.perf_counter() - t0)
            compute_start = done = None
            if cuda:
                compute_stream.wait_event(uploaded)
                compute_start = torch.cuda.Event(enable_timing=True)
                compute_start.record()
            record.note((x, y, mask))
            if sharded is not None:
                sharded_step(x, y, mask)
            else:
                feats = _apply_chain(members, x, mask)
                carry = step_fn(carry, feats, y, mask) if needs_mask else step_fn(carry, feats, y)
            if cuda:
                for t in moved:  # filled on the copy stream, read here
                    t.record_stream(compute_stream)
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                events.append((copy_start, uploaded, compute_start, done))
            chunks_c.inc()
            report.chunks += 1
            progress["dispatched"] += 1
            start, stop = chunk[3]
            progress["rows"] += stop - start
            folded_log.append((start, stop, sharded.p_d if sharded is not None else 1, chunk_rows))
            if report.chunks == 1:
                report.compiles_first_chunk = len(record.traces)
            return done

        def consume(done, _chunk):
            # The completion barrier for chunk i, one chunk behind the
            # dispatch frontier, so chunk timings and backpressure are real.
            if done is not None:
                # The designed barrier, one chunk behind the dispatch
                # frontier.  # keystone: allow-sync
                done.synchronize()
            report.compute_done_t.append(time.perf_counter() - t0)

        steady_accum = 0
        attempt_base: Optional[int] = None
        queue = None
        # Stall and buffer peaks of the attempts a shard loss abandoned.
        stall_before, peak_before = 0.0, 0
        try:
            with _spans.span(
                "stream:fold", chunks=len(windows), chunk_rows=chunk_rows, start_chunk=start_chunk
            ):
                while True:
                    queue = PrefetchQueue(
                        iter(attempt_windows),
                        prepare,
                        depth=self.prefetch,
                        workers=min(self.workers, self.prefetch),
                        size_of=lambda chunk: _host_nbytes(chunk[:3]),
                    )
                    try:
                        stream_pipelined(queue, stage, compute, consume, prefetch=2 if cuda else 1)
                    except ShardLossError as loss:
                        # Join this attempt's prefetch workers before the
                        # salvage: an abandoned attempt leaks no threads.
                        queue.close()
                        stall_before += queue.stall_s
                        peak_before = max(peak_before, queue.peak_live_bytes)
                        if report.chunks:
                            prev = report.compiles_first_chunk if attempt_base is None else attempt_base
                            steady_accum += len(record.traces) - prev
                        part, sharded, carry, attempt_windows, chunk_rows = self._salvage_shard_loss(
                            loss, sharded, part, step_fn, attempt_seed, folded_log,
                            attempt_windows, progress["dispatched"], chunk_rows, report,
                        )
                        attempt_seed = carry
                        record = _shared_step_record(self.members, step_fn, part)
                        # A loss before ANY chunk folded: the next attempt's
                        # first chunk is the fold's first chunk.
                        attempt_base = len(record.traces) if report.chunks else None
                        folded_log.clear()
                        progress["dispatched"] = 0
                        progress["suspended"] = True
                        continue
                    except FoldPreempted:
                        # Graceful yield: the cursor is committed and the
                        # report marked; the prefix carry is returned below.
                        pass
                    break
                if sharded is not None:
                    carry = self._finish_sharded(sharded, report, len(windows))
            if cuda and report.bytes_transferred and report.preempted_at_chunk is None:
                report.device_copy_ms = [s.elapsed_time(u) for s, u, _, _ in events]
                report.device_compute_ms = [s.elapsed_time(d) for _, _, s, d in events]
                report.device_overlap_ok = all(
                    events[i + 1][0].elapsed_time(events[i][3]) > 0
                    for i in range(len(events) - 1)
                )
        finally:
            if queue is not None:
                queue.close()
                report.stall_s = stall_before + queue.stall_s
                report.host_buffer_peak_bytes = max(peak_before, queue.peak_live_bytes) + in_hand_peak
            base = report.compiles_first_chunk if attempt_base is None else attempt_base
            report.compiles_steady_state = steady_accum + len(record.traces) - base
            _publish_report(report)
        preempted = report.preempted_at_chunk is not None
        resume_rows = 0
        if durable is not None:
            if not preempted:
                # The fit completed: a resume entry pointing into its
                # middle must not outlive it. A PREEMPTED fold's cursor is
                # the resume point the next lease needs.
                durable.complete()
            resume_rows = durable.resume_rows
        if (
            report.compute_done_t
            and report.chunks == len(windows)
            and report.resumed_from_chunk is None
            and not preempted
        ):
            # A whole fold's throughput goes to the enclosing harvest
            # frame (a resumed or preempted one measured a part: its
            # rows/s would be a lie), so a rows/s prediction (the
            # measured-knob chunk winner) is drift-scored in its unit.
            wall = max(report.compute_done_t[-1], 1e-9)
            _cost.note_stream_result(report.num_examples / wall, n)
        # Rows THIS fold absorbed: a resumed fold re-ingests only the
        # suffix past the cursor (the cursor's rows live in the seeding
        # state, and estimators add state.num_examples); a preempted fold
        # absorbed only the dispatched prefix.
        absorbed = progress["rows"] - resume_rows if preempted else n - resume_rows
        info = {"num_examples": absorbed, "chunks": report.chunks, "report": report}
        return carry, info

    def _finish_sharded(self, sharded: "_ShardedCarry", report: StreamReport, num_windows: int):
        """THE cross-shard reduction of a partitioned fold, once at finish
        (an O(d²) payload however many chunks streamed), onto the
        stream's device, and its plan-pure accounting: with the reduced
        leaves split into feature bytes B_f (blocked over ``model``) and
        the remainder B_r, each block holds B_f/p_m + B_r; the data-axis
        sum moves one block per non-root row shard per model column, the
        model-axis reassembly one block per non-root model column."""
        from ..parallel.partitioner import record_collective_bytes, record_imbalance

        carry = sharded.merge(self.device)
        if report.chunks:
            p_d, p_m = sharded.p_d, sharded.p_m
            reduced = _tree_nbytes(carry)
            b_f = reduced
            if sharded.layout is not None:
                b_f = sum(
                    leaf.numel() * leaf.element_size()
                    for leaf, ax in zip(tree_leaves(carry), sharded.layout)
                    if ax is not None
                )
            b_r = reduced - b_f
            report.collective_bytes_data = (b_f + p_m * b_r) * (p_d - 1)
            report.collective_bytes_model = (b_f // p_m + b_r) * (p_m - 1)
            report.collective_bytes = report.collective_bytes_data + report.collective_bytes_model
            record_collective_bytes(report.collective_bytes_data, axis="data")
            record_collective_bytes(report.collective_bytes_model, axis="model")
            record_imbalance("fit_stream", self.num_examples, num_windows * self.chunk_rows)
        return carry

    def _salvage_shard_loss(
        self, loss, sharded, part, step_fn, seed, folded_log, attempt_windows, dispatched, chunk_rows, report
    ):
        """Absorb a mid-stream shard loss and hand back the next attempt's
        ``(part, sharded, carry, windows, chunk_rows)``.

        The lost shard's carry block is gone; the flat block index is
        row-major over (data, model), so a loss on EITHER axis maps to one
        row group, and the whole group is dropped (with feature-blocked
        partials no single column holds a complete one). The surviving
        groups' partials merge via the additive contract; when group 0 —
        which carries the fold's seed — was lost, the seed is added back.
        The rows only the lost group had folded (its slice of every chunk
        dispatched this attempt, per ``folded_log``) become recovery
        windows, re-ingested ahead of the untouched remainder. The
        partitioner re-decides on the shrunken mesh; an ineligible
        decision continues on one device — elasticity is never an error.
        """
        from ..parallel.mesh import mesh_without
        from ..parallel.partitioner import Partitioner, record_decision
        from ..reliability.recovery import get_recovery_log

        label = f"fit_stream[{len(self.members)}ops]"
        lost, p_m = loss.lost_shard, part.model_shards
        lost_row = lost // p_m
        get_recovery_log().record(
            "shard_loss", label, lost_shard=lost, shards=part.total_shards, chunk_index=loss.chunk_index
        )
        _names.metric(_names.DURABLE_SHARD_LOSSES).inc()
        report.shard_losses += 1

        surviving = sharded.merge(self.device, drop_row=lost_row)
        if lost_row == 0:
            surviving = tuple(s + a.to(self.device) for s, a in zip(surviving, tree_leaves(seed)))

        # Row group i held padded rows [i·rps, (i+1)·rps) of each chunk, so
        # the lost LOGICAL rows of a window (s, e) are the contiguous
        # [s + lost_row·rps, min(s + (lost_row+1)·rps, e)).
        recovery: List[Tuple[int, int]] = []
        for s, e, shards_f, rows_f in folded_log:
            rps = rows_f // shards_f
            lo, hi = s + lost_row * rps, min(s + (lost_row + 1) * rps, e)
            if lo < hi:
                recovery.append((lo, hi))
        remaining = list(attempt_windows[dispatched:])

        decision = Partitioner(mesh=mesh_without(part.mesh, lost)).decide_stream(
            label, chunk_rows, rows=self.num_examples, record=False
        )
        # Metrics yes, plan report no: a mid-fold re-decision is runtime.
        record_decision(decision, to_report=False)
        new_part = decision if decision.eligible else None
        if new_part is not None and new_part.model_shards > 1:
            new_part = self._validate_model_axis(new_part, step_fn, surviving)
        if new_part is not None:
            new_sharded = _ShardedCarry(new_part, step_fn, surviving)
            chunk_rows = new_part.chunk_rows or chunk_rows
        else:
            new_sharded = None
        report.shards = new_part.shards if new_part is not None else 1
        report.model_shards = new_part.model_shards if new_part is not None else 1
        report.mesh_shape = tuple(new_part.mesh_shape) if new_part is not None else ()
        report.reingested_chunks += len(recovery)
        _names.metric(_names.DURABLE_REINGESTED_CHUNKS).inc(len(recovery))
        _names.metric(_names.DURABLE_RESUMES).inc(kind="shard")
        get_recovery_log().record(
            "shard_resume", label, shards=report.shards,
            recovery_chunks=len(recovery), remaining_chunks=len(remaining),
        )
        return new_part, new_sharded, surviving, recovery + remaining, chunk_rows

    def _validate_model_axis(self, part, step_fn, carry):
        """Fold-time check of an optimistically granted model axis against
        what the planner lacked: the step's blocked-carry protocol and the
        REAL featurized width in the estimator's carry. A failure demotes
        the plan to row-only on the same mesh (``demote_model_axis``); a
        demotion that leaves no row axis to shard returns None (the
        single-device fold)."""
        from ..parallel.partitioner import (
            R_BELOW_WIDTH_FLOOR,
            R_MODEL_INDIVISIBLE,
            demote_model_axis,
            partition_min_width_per_shard,
        )

        p_m = part.model_shards
        layout = _carry_layout(step_fn, carry)
        reason = detail = ""
        if layout is None or all(ax is None for ax in layout):
            reason = R_MODEL_INDIVISIBLE
            detail = f"step {getattr(step_fn, '__name__', type(step_fn).__name__)} declares no blocked-carry protocol"
        else:
            widths = {leaf.shape[ax] for leaf, ax in zip(tree_leaves(carry), layout) if ax is not None}
            width = max(widths)
            if any(w % p_m for w in widths):
                reason = R_MODEL_INDIVISIBLE
                detail = f"featurized width {sorted(widths)} not divisible by {p_m} model shards"
            elif width < p_m * partition_min_width_per_shard():
                reason = R_BELOW_WIDTH_FLOOR
                detail = (
                    f"featurized width {width} < {p_m} shards × "
                    f"{partition_min_width_per_shard()} min cols/shard"
                )
        if not reason:
            return part
        demoted = demote_model_axis(part, reason, detail)
        return demoted if demoted.eligible else None



# ------------------------------------------------------------------- operator


class StreamingFitOperator(EstimatorOperator):
    """An estimator node rewritten onto the streaming engine.

    Wraps the original estimator plus the featurize-chain members that
    were between it and the data source; depends directly on the RAW data
    (plus labels). At force time it streams chunks into
    ``estimator.fit_stream`` on the estimator's device; if run-time
    eligibility fails (small data, or a :class:`StreamingFallback`
    reason) it reproduces the materialized path exactly — member-by-member
    batch application then ``fit_datasets`` — and records why on the
    ``stream:fit`` span's ``fallback`` attribute.
    """

    #: PartitionDecision pinned by ``workflow/optimize.py::PartitionPlanRule``
    #: on a copy of this operator (None: the single-device chunk plan).
    partition = None

    def __init__(
        self,
        estimator: EstimatorOperator,
        members: Sequence[TransformerOperator],
        chunk_rows: Optional[int] = None,
        prefetch: Optional[int] = None,
    ):
        self.estimator = estimator
        self.members = tuple(members)
        self.chunk_rows = chunk_rows
        self.prefetch = prefetch

    @property
    def label(self) -> str:
        est = getattr(self.estimator, "label", type(self.estimator).__name__)
        return f"StreamFit[{est}+{len(self.members)}ops]"

    @property
    def solver_precision(self):
        """The wrapped estimator's precision pin, surfaced so the inherited
        ``EstimatorOperator.execute`` scopes the whole fit (stream and
        materialized paths alike) under it."""
        return getattr(self.estimator, "solver_precision", None)

    def fit_datasets(self, datasets: List[Dataset]) -> TransformerOperator:
        data = datasets[0]
        labels = datasets[1] if len(datasets) > 1 else None
        chunk_rows = self.chunk_rows or stream_chunk_rows()
        with _spans.span(
            "stream:fit",
            estimator=str(getattr(self.estimator, "label", "")),
            members=len(self.members),
            chunk_rows=chunk_rows,
        ) as span:
            # A head whose size is unknowable (a Dataset without a
            # length) is a fallback, not a crash.
            try:
                n_rows = len(data)
            except (TypeError, NotImplementedError):
                n_rows = -1
            if streaming_enabled() and n_rows >= max(2 * chunk_rows, stream_min_rows()):
                try:
                    stream = ChunkStream(
                        data,
                        labels,
                        self.members,
                        chunk_rows=chunk_rows,
                        prefetch=self.prefetch,
                        device=getattr(self.estimator, "device", None),
                        partition=self.partition,
                    )
                    # Durable fits: with a checkpoint store attached, arm
                    # mid-fit cursor checkpoints and look for a resume
                    # entry a killed predecessor left behind. A valid
                    # entry seeds the fold and only chunks past its cursor
                    # are re-ingested; a stale one is refused (KV306 —
                    # VerificationError in strict mode, which propagates).
                    from .executor import PipelineEnv

                    store = PipelineEnv.get_or_create().checkpoint
                    if store is not None:
                        from ..reliability.durable import arm_durable_fold

                        stream.durable, resume_state = arm_durable_fold(stream, self.estimator, store)
                        if resume_state is not None:
                            span.set_attribute("resumed_from_chunk", stream.durable.start_chunk)
                            return self.estimator.fit_stream(stream, state=resume_state)
                    return self.estimator.fit_stream(stream)
                except StreamingFallback as e:
                    logger.info(
                        "streaming fit of %s fell back to the materialized path: %s",
                        self.label, e,
                    )
                    span.set_attribute("fallback", str(e))
            else:
                span.set_attribute("fallback", "below row floor or disabled")
            featurized = data
            for m in self.members:
                featurized = m.batch_transform([featurized])
            rest = [labels] if labels is not None else []
            return self.estimator.fit_datasets([featurized] + rest)


# ----------------------------------------------------------------- the rule


def _streamable_member(op) -> bool:
    from .fusion import FusedTransformerOperator, is_fusable

    return isinstance(op, FusedTransformerOperator) or is_fusable(op)


class StreamingPlanRule(Rule):
    """Rewrite eligible ``data → featurize-chain → estimator`` shapes onto
    the streaming engine.

    Runs after fusion: the chain it absorbs is usually already one
    FusedTransformerOperator, whose members it flattens into the
    per-chunk step. A chain member is absorbable under exactly the fusion
    rules (array-in/array-out, single consumer, unary, outside the prefix
    map); the walk stops at Cacher nodes, saveable prefixes and fan-out —
    the stream then starts from that boundary's materialized output.

    Plan-time gates: the estimator advertises ``supports_fit_stream``; a
    known-size head (a bound ``DatasetOperator``) must hold at least
    max(2·chunk, ``KEYSTONE_STREAM_MIN_ROWS``) rows; an unknown-size head
    (e.g. a Cacher) is rewritten only when there is a featurize chain to
    run per chunk, and the operator's own run-time gate makes the final
    call.
    """

    def __init__(self, chunk_rows: Optional[int] = None):
        self.chunk_rows = chunk_rows

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        if not streaming_enabled():
            return graph, prefixes
        chunk_rows = self.chunk_rows or stream_chunk_rows()
        rewrites = 0
        for node in sorted(graph.nodes):
            if node not in graph.operators:
                continue  # absorbed into an earlier rewrite
            op = graph.get_operator(node)
            if isinstance(op, StreamingFitOperator) or not isinstance(op, EstimatorOperator):
                continue
            if not getattr(op, "supports_fit_stream", False):
                continue
            deps = graph.get_dependencies(node)
            if not deps:
                continue
            dependents = graph.dependents()
            chain: List[NodeId] = []
            cur = deps[0]
            while isinstance(cur, NodeId):
                if (
                    len(dependents.get(cur, [])) == 1
                    and cur not in prefixes
                    and len(graph.get_dependencies(cur)) == 1
                    and _streamable_member(graph.get_operator(cur))
                ):
                    chain.append(cur)
                    cur = graph.get_dependencies(cur)[0]
                else:
                    break
            head = cur
            if isinstance(head, SourceId):
                continue  # unbound input: nothing to chunk at plan time
            head_op = graph.get_operator(head)
            if isinstance(head_op, DatasetOperator):
                ds = head_op.dataset
                if not isinstance(ds, (ArrayDataset, ObjectDataset)):
                    continue
                if len(ds) < max(2 * chunk_rows, stream_min_rows()):
                    continue
            elif not chain:
                # Unknown size AND nothing to run per chunk: the rewrite
                # could only reproduce the materialized fit.
                continue

            from .fusion import FusedTransformerOperator

            members: List[TransformerOperator] = []
            for cn in reversed(chain):  # head-first application order
                m = graph.get_operator(cn)
                if isinstance(m, FusedTransformerOperator):
                    members.extend(m.members)
                else:
                    members.append(m)
            streaming_op = StreamingFitOperator(op, members, chunk_rows=self.chunk_rows)
            graph = graph.set_operator(node, streaming_op)
            graph = graph.set_dependencies(node, (head,) + tuple(deps[1:]))
            for cn in chain:  # estimator-adjacent first: now unreferenced
                graph = graph.remove_node(cn)
            rewrites += 1
        if rewrites:
            _names.metric(_names.STREAM_PLANS).inc(rewrites)
        return graph, prefixes


__all__ = [
    "ChunkSpec",
    "ChunkStream",
    "StreamReport",
    "StreamingFallback",
    "StreamingFitOperator",
    "StreamingPlanRule",
    "chain_class",
    "last_stream_report",
    "set_streaming_enabled",
    "stream_chunk_rows",
    "stream_min_rows",
    "stream_pipelined",
    "stream_prefetch_depth",
    "streaming_disabled",
    "streaming_enabled",
]
