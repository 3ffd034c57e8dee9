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

Left out (later slices, ROADMAP Queue A items 12–14): the partitioned
(sharded, 2-D) chunk plans and shard-loss recovery, the durable cursor
checkpoints and resume, the scheduler lease (preemption at a chunk
boundary), and the cost-observatory and profile-store observations.
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
    script and tests assert on (overlap, first applications, memory).

    The partition, durability and preemption fields keep the JAX
    package's names and single-device values until those paths are
    ported (ROADMAP Queue A items 12–14)."""

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


def _shared_step_record(members: tuple, step_fn: Callable) -> _StepRecord:
    key = tuple(id(m) for m in members) + (id(step_fn),)
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
    ):
        self.data = data
        self.labels = labels
        self.members = tuple(members)
        self.chunk_rows = chunk_rows or stream_chunk_rows()
        self.prefetch = prefetch or stream_prefetch_depth()
        self.workers = workers or min(default_ingest_workers(), 4)
        self.device = resolve_device(device)
        self.num_examples = len(data)
        self._feat_aval = None

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

        record = _shared_step_record(self.members, step_fn)
        members = self.members
        # Index-keyed folds (sketch/core.py) declare needs_mask: the step
        # receives the chunk's pad mask — whose lane holds absolute row
        # indices — as a fourth argument. Gram steps keep three.
        needs_mask = bool(getattr(step_fn, "needs_mask", False))
        windows = [(s, min(s + chunk_rows, n)) for s in range(0, n, chunk_rows)]
        report = StreamReport(
            chunk_rows=chunk_rows,
            num_examples=n,
            prefetch_depth=self.prefetch,
            state_bytes_per_device=_tree_nbytes(carry),
        )
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

        def compute(staged, _chunk):
            nonlocal carry
            x, y, mask, moved, copy_start, uploaded = staged
            probe("streaming.chunk")
            report.dispatch_t.append(time.perf_counter() - t0)
            compute_start = done = None
            if cuda:
                compute_stream.wait_event(uploaded)
                compute_start = torch.cuda.Event(enable_timing=True)
                compute_start.record()
            record.note((x, y, mask))
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
            if report.chunks == 1:
                report.compiles_first_chunk = len(record.traces)
            return done

        def consume(done, _chunk):
            # The completion barrier for chunk i, one chunk behind the
            # dispatch frontier, so chunk timings and backpressure are real.
            if done is not None:
                done.synchronize()
            report.compute_done_t.append(time.perf_counter() - t0)

        queue = PrefetchQueue(
            iter(windows),
            prepare,
            depth=self.prefetch,
            workers=min(self.workers, self.prefetch),
            size_of=lambda chunk: _host_nbytes(chunk[:3]),
        )
        try:
            with _spans.span("stream:fold", chunks=len(windows), chunk_rows=chunk_rows):
                stream_pipelined(queue, stage, compute, consume, prefetch=2 if cuda else 1)
            if cuda and report.bytes_transferred:
                report.device_copy_ms = [s.elapsed_time(u) for s, u, _, _ in events]
                report.device_compute_ms = [s.elapsed_time(d) for _, _, s, d in events]
                report.device_overlap_ok = all(
                    events[i + 1][0].elapsed_time(events[i][3]) > 0
                    for i in range(len(events) - 1)
                )
        finally:
            queue.close()
            report.stall_s = queue.stall_s
            report.host_buffer_peak_bytes = queue.peak_live_bytes + in_hand_peak
            report.compiles_steady_state = len(record.traces) - report.compiles_first_chunk
            _publish_report(report)
        info = {"num_examples": n, "chunks": report.chunks, "report": report}
        return carry, info


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
                    )
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
    "last_stream_report",
    "set_streaming_enabled",
    "stream_chunk_rows",
    "stream_min_rows",
    "stream_pipelined",
    "stream_prefetch_depth",
    "streaming_disabled",
    "streaming_enabled",
]
