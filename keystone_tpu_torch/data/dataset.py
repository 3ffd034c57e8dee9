"""Dataset substrate: host object lists and device tensors.

Port of ``keystone_tpu/data/dataset.py``:

- ``ObjectDataset`` — a host-side list of Python objects (strings, token
  lists, scipy CSR rows).
- ``ArrayDataset`` — a tensor, or a tuple, list or dict of tensors (what
  ``GatherTransformer`` emits), with a shared leading example axis on an
  explicit device. ``num_examples`` is the logical row count; rows past
  it are zero padding and are masked out of statistics.
- ``BucketedDataset`` — a logical dataset stored as static-shape groups
  of ``ArrayDataset``s; batched transformers map per bucket, estimators
  consume the concatenation.

``fetch_rows`` / ``iter_chunks`` are the chunk-windowing primitives of
the streaming engine (``workflow/streaming.py``). A host dataset yields
host numpy windows with their stored dtype (the engine narrows with
:func:`transfer_dtype` and copies into pinned memory); a CUDA-resident
``ArrayDataset`` yields device slices, so a streamed fit over it moves
no bytes across the host link.

``ArrayDataset.shard(mesh, axis)`` lays a dataset out over a mesh
(``parallel/mesh.py``): rows zero-padded to the axis size, the leaves on
the mesh's first device, and :meth:`ArrayDataset.shard_views` the
per-shard row views the sharded solvers take.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..envknobs import env_str
from ..utils.tree import tree_leaves, tree_map


def default_ingest_workers() -> int:
    """Host-side worker count shared by every ingest-adjacent pool:
    ``ObjectDataset.map`` and the streaming engine's prefetch pipeline.
    ``KEYSTONE_INGEST_WORKERS`` overrides; the default derives from the
    host's core count (capped: decode pools past ~32 threads just fight
    the interpreter lock and the page cache)."""
    raw = env_str("KEYSTONE_INGEST_WORKERS").strip()
    if raw:
        return max(1, int(raw))
    return max(2, min(32, os.cpu_count() or 4))


def transfer_dtype(dtype) -> np.dtype:
    """The dtype a host array should CROSS the host→device link as.

    Narrow dtypes (uint8 images, int16 audio, bool masks) stay narrow:
    transfer scales with bytes, and uint8 is 4× less traffic than the
    float32 the math eventually wants; the consumer casts on the device.
    64-bit host types squeeze to 32 bits, as the port's datasets store
    them anyway."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype == np.int64:
        return np.dtype(np.int32)
    if dtype == np.uint64:
        return np.dtype(np.uint32)
    if dtype == np.complex128:
        return np.dtype(np.complex64)
    return dtype


class Dataset:
    """Abstract logical collection of examples."""

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def take(self, n: int) -> List[Any]:
        return self.collect()[:n]

    def cache(self) -> "Dataset":
        """Materialization point; both kinds are already materialized."""
        return self

    def fetch_rows(self, start: int, stop: int) -> Any:
        """The ``[start, stop)`` example window, stored dtype preserved.
        The one chunk-windowing primitive: :meth:`iter_chunks` and the
        streaming engine's prefetch workers both go through it, so window
        semantics cannot diverge. Datasets without a chunkable layout do
        not implement it; the streaming fit then takes the materialized
        path."""
        raise NotImplementedError(f"{type(self).__name__} is not chunkable")

    def iter_chunks(self, chunk_rows: int) -> Iterator[Tuple[Any, int]]:
        """Yield ``(window, num_valid_rows)`` for windows of at most
        ``chunk_rows`` examples, in order (see :meth:`fetch_rows`)."""
        n = len(self)
        for start in range(0, n, chunk_rows):
            stop = min(start + chunk_rows, n)
            yield self.fetch_rows(start, stop), stop - start

    @property
    def num_shards(self) -> int:
        return 1

    def per_shard_counts(self) -> List[int]:
        n = len(self)
        k = self.num_shards
        base, extra = divmod(n, k)
        return [base + (1 if i < extra else 0) for i in range(k)]


class ObjectDataset(Dataset):
    """Host-side list of arbitrary Python objects."""

    def __init__(self, items: Sequence[Any]):
        self._items = list(items)

    def map(self, fn: Callable[[Any], Any], parallel: Optional[bool] = None) -> "ObjectDataset":
        """Per-item host map, in order, fanned over a thread pool for
        datasets of 64 items or more (pays off when ``fn`` releases the
        interpreter lock, as numpy does). ``fn`` must be safe to call
        concurrently; pass ``parallel=False`` for functions with shared
        mutable state, ``parallel=True`` to force the pool. Pool width is
        :func:`default_ingest_workers`. Each task maps a contiguous slice
        of items (four slices per worker): a task per item made the
        100,000-line Stupid Backoff fit, whose string functions hold the
        interpreter lock, take 13.4 s against 3.2 s with slices (an
        8-CPU host, ``chip_smoke.py`` ``stupid_backoff``)."""
        if parallel is None:
            parallel = len(self._items) >= 64
        if parallel:
            from concurrent.futures import ThreadPoolExecutor

            workers = default_ingest_workers()
            step = -(-len(self._items) // (4 * workers)) or 1
            slices = [self._items[i : i + step] for i in range(0, len(self._items), step)]
            with ThreadPoolExecutor(max_workers=workers) as pool:
                mapped = pool.map(lambda part: [fn(x) for x in part], slices)
                return ObjectDataset([y for part in mapped for y in part])
        return ObjectDataset([fn(x) for x in self._items])

    def collect(self) -> List[Any]:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def to_arrays(self, device: DeviceLike = None) -> "ArrayDataset":
        """Stack equal-shape items (tensors, arrays, or tuples/lists/dicts
        of them) into an ArrayDataset on ``device``."""
        if not self._items:
            raise ValueError("cannot stack an empty dataset")
        stacked = tree_map(_stack, *self._items)
        return ArrayDataset(stacked, device=device)

    def fetch_rows(self, start: int, stop: int) -> Any:
        """Stack one window of items as host numpy arrays. Only the
        window is ever stacked, so host residency stays O(chunk); the
        streaming prefetch workers call this concurrently."""
        window = self._items[start:stop]
        return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *window)

    def __repr__(self) -> str:
        return f"ObjectDataset(n={len(self._items)})"


def _stack(*xs: Any) -> Any:
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _as_tensor(data: Any, device: DeviceLike) -> torch.Tensor:
    """A tensor on ``device`` (``None`` keeps a tensor where it is and
    puts host arrays on the default device). 64-bit host floats and ints
    narrow to 32 bits, as the JAX package's transfer rule does."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(resolve_device(device))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.as_tensor(arr, device=resolve_device(device))


def _leading_dim(tree: Any) -> int:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty pytree")
    if any(leaf.ndim == 0 for leaf in leaves):
        raise ValueError("an ArrayDataset needs a leading example axis")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError("inconsistent leading dimensions in dataset pytree")
    return n


class ArrayDataset(Dataset):
    """A tensor, or a tuple/list/dict of tensors, with a shared leading
    example axis, on one device."""

    def __init__(
        self,
        data: Any,
        num_examples: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.data = tree_map(lambda a: _as_tensor(a, device), data)
        physical = _leading_dim(self.data)
        self.num_examples = num_examples if num_examples is not None else physical
        if self.num_examples > physical:
            raise ValueError("num_examples exceeds physical leading dim")

    def __len__(self) -> int:
        return self.num_examples

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.data)[0].device

    @property
    def physical_rows(self) -> int:
        return _leading_dim(self.data)

    def collect(self) -> List[Any]:
        return self.take(self.num_examples)

    def take(self, n: int) -> List[Any]:
        n = min(n, self.num_examples)
        host = tree_map(lambda a: a[:n].cpu().numpy(), self.data)
        return [tree_map(lambda a: a[i], host) for i in range(n)]

    def map(self, fn: Callable[[Any], Any]) -> ObjectDataset:
        """Per-item host map."""
        return ObjectDataset([fn(x) for x in self.collect()])

    def map_batched(self, fn: Callable[[Any], Any]) -> "ArrayDataset":
        """Apply ``fn`` to the whole batch (a tensor or a tree of them)."""
        return ArrayDataset(fn(self.data), self.num_examples)

    def fetch_rows(self, start: int, stop: int) -> Any:
        """The ``[start, stop)`` window of every leaf: host numpy arrays
        when the dataset lies on the CPU, device slices (views, no copy)
        when it lies on a card — a chunked read never round-trips through
        the host."""

        def window(a: torch.Tensor):
            part = a[start:stop]
            return part.numpy() if part.device.type == "cpu" else part

        return tree_map(window, self.data)

    def padded_to(self, multiple: int) -> "ArrayDataset":
        """Zero-pad the leading axis up to the next multiple of
        ``multiple``, on the dataset's device. Dtype-preserving: a uint8
        batch pads to uint8 (an upcast here would widen every later
        transfer 4×)."""
        physical = self.physical_rows
        target = ((physical + multiple - 1) // multiple) * multiple
        if target == physical:
            return self
        pad = target - physical

        def pad_leaf(a: torch.Tensor) -> torch.Tensor:
            return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

        return ArrayDataset(tree_map(pad_leaf, self.data), self.num_examples)

    def shard(self, mesh, axis: str = "data") -> "ArrayDataset":
        """This dataset laid out over ``mesh`` along the leading axis: rows
        zero-padded to a multiple of the ``axis`` size (the analog of the
        reference's row-partitioned RDDs), every leaf on the mesh's first
        device (host leaves crossed at their transfer dtype when the
        dataset was built). ``num_shards`` then reads the axis size, and
        :meth:`shard_views` gives each shard's rows."""
        ds = self.padded_to(mesh.shape[axis])
        out = ArrayDataset(ds.data, self.num_examples, device=mesh.flat_devices[0])
        out._mesh_axis = (mesh, axis)
        return out

    def shard_views(self) -> Any:
        """Per-leaf :class:`~keystone_tpu_torch.parallel.collectives.Sharded`
        row layouts of a dataset made by :meth:`shard` (views on the
        mesh's device)."""
        mesh_axis = getattr(self, "_mesh_axis", None)
        if mesh_axis is None:
            raise ValueError("shard_views() needs a dataset laid out by shard(mesh, axis)")
        from ..parallel.collectives import P, shard_tensor

        mesh, axis = mesh_axis
        return tree_map(lambda a: shard_tensor(a, mesh, P(axis)), self.data)

    @property
    def num_shards(self) -> int:
        mesh_axis = getattr(self, "_mesh_axis", None)
        return 1 if mesh_axis is None else mesh_axis[0].shape[mesh_axis[1]]

    def mask(self) -> torch.Tensor:
        """1.0 for real rows, 0.0 for padding — shape (physical_rows,)."""
        rows = torch.arange(self.physical_rows, device=self.device)
        return (rows < self.num_examples).to(torch.float32)

    def __repr__(self) -> str:
        shapes = tree_map(lambda a: tuple(a.shape), self.data)
        return f"ArrayDataset(n={self.num_examples}, shapes={shapes}, device={self.device})"


class BucketedDataset(Dataset):
    """A logical dataset physically stored as static-shape groups.

    Batched transformers map per bucket (one static-shape computation
    each); estimators consume :meth:`concat`. Example order is
    bucket-major and stable across ops, so labels aligned to ``concat()``
    order stay aligned downstream. It has no :meth:`fetch_rows`: a
    streamed fit over it takes the materialized path.
    """

    def __init__(self, buckets: Sequence[ArrayDataset]):
        if not buckets:
            raise ValueError("BucketedDataset needs at least one bucket")
        self.buckets = list(buckets)

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)

    def collect(self) -> List[Any]:
        out: List[Any] = []
        for b in self.buckets:
            out.extend(b.collect())
        return out

    def map(self, fn: Callable[[Any], Any]) -> ObjectDataset:
        return ObjectDataset([fn(x) for x in self.collect()])

    def map_datasets(self, fn: Callable[[ArrayDataset], ArrayDataset]) -> "BucketedDataset":
        """Apply a per-bucket Dataset→Dataset function."""
        return BucketedDataset([fn(b) for b in self.buckets])

    def map_batched(self, fn: Callable[[Any], Any]) -> "BucketedDataset":
        return BucketedDataset([b.map_batched(fn) for b in self.buckets])

    @property
    def num_shards(self) -> int:
        return len(self.buckets)

    def per_shard_counts(self) -> List[int]:
        return [len(b) for b in self.buckets]

    def concat(self) -> ArrayDataset:
        """Concatenate the buckets' logical rows along the example axis
        (valid once trailing shapes agree)."""
        datas = [tree_map(lambda a, n=len(b): a[:n], b.data) for b in self.buckets]
        return ArrayDataset(tree_map(lambda *xs: torch.cat(xs), *datas))

    def __repr__(self) -> str:
        return f"BucketedDataset(buckets={[len(b) for b in self.buckets]})"


def as_dataset(value: Any) -> Dataset:
    """Coerce lists/arrays/tensors into a Dataset."""
    if isinstance(value, Dataset):
        return value
    if isinstance(value, (list, tuple)):
        return ObjectDataset(list(value))
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return ArrayDataset(value)
    raise TypeError(f"cannot interpret {type(value)} as a Dataset")
