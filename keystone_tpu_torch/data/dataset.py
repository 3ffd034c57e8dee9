"""Dataset substrate: host object lists and device tensors.

Port of ``keystone_tpu/data/dataset.py``:

- ``ObjectDataset`` — a host-side list of Python objects (strings, token
  lists, scipy CSR rows).
- ``ArrayDataset`` — a tensor, or a tuple, list or dict of tensors (what
  ``GatherTransformer`` emits), with a shared leading example axis on an
  explicit device. ``num_examples`` is the logical row count; rows past
  it are zero padding and are masked out of statistics.

Left out for now: ``padded_to``, ``shard``, ``iter_chunks``,
``fetch_rows`` and ``BucketedDataset``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.tree import tree_leaves, tree_map


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

    def map(self, fn: Callable[[Any], Any]) -> "ObjectDataset":
        """Per-item host map, in order."""
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

    def mask(self) -> torch.Tensor:
        """1.0 for real rows, 0.0 for padding — shape (physical_rows,)."""
        rows = torch.arange(self.physical_rows, device=self.device)
        return (rows < self.num_examples).to(torch.float32)

    def __repr__(self) -> str:
        shapes = tree_map(lambda a: tuple(a.shape), self.data)
        return f"ArrayDataset(n={self.num_examples}, shapes={shapes}, device={self.device})"


def as_dataset(value: Any) -> Dataset:
    """Coerce lists/arrays/tensors into a Dataset."""
    if isinstance(value, Dataset):
        return value
    if isinstance(value, (list, tuple)):
        return ObjectDataset(list(value))
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return ArrayDataset(value)
    raise TypeError(f"cannot interpret {type(value)} as a Dataset")
