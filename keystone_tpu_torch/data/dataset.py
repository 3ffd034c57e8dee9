"""Dataset substrate: host object lists and device tensors.

Port of ``keystone_tpu/data/dataset.py``, cut to what the hashing-TF →
block least-squares slice uses:

- ``ObjectDataset`` — a host-side list of Python objects (strings, token
  lists, scipy CSR rows).
- ``ArrayDataset`` — one tensor with a leading example axis on an
  explicit device. ``num_examples`` is the logical row count; rows past
  it are zero padding and are masked out of statistics.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class Dataset:
    """Abstract logical collection of examples."""

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


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
        """Stack equal-shape items into an ArrayDataset on ``device``."""
        if not self._items:
            raise ValueError("cannot stack an empty dataset")
        return ArrayDataset(np.stack([np.asarray(x) for x in self._items]), device=device)

    def __repr__(self) -> str:
        return f"ObjectDataset(n={len(self._items)})"


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


class ArrayDataset(Dataset):
    """A tensor with a leading example axis, on one device."""

    def __init__(
        self,
        data: Any,
        num_examples: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.data = _as_tensor(data, device)
        if self.data.ndim == 0:
            raise ValueError("an ArrayDataset needs a leading example axis")
        physical = self.data.shape[0]
        self.num_examples = num_examples if num_examples is not None else physical
        if self.num_examples > physical:
            raise ValueError("num_examples exceeds physical leading dim")

    def __len__(self) -> int:
        return self.num_examples

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def physical_rows(self) -> int:
        return self.data.shape[0]

    def collect(self) -> List[Any]:
        host = self.data[: self.num_examples].cpu().numpy()
        return [host[i] for i in range(self.num_examples)]

    def map(self, fn: Callable[[Any], Any]) -> ObjectDataset:
        """Per-item host map."""
        return ObjectDataset([fn(x) for x in self.collect()])

    def map_batched(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ArrayDataset":
        """Apply ``fn`` to the whole batch tensor."""
        return ArrayDataset(fn(self.data), self.num_examples)

    def mask(self) -> torch.Tensor:
        """1.0 for real rows, 0.0 for padding — shape (physical_rows,)."""
        rows = torch.arange(self.physical_rows, device=self.data.device)
        return (rows < self.num_examples).to(torch.float32)

    def __repr__(self) -> str:
        return (
            f"ArrayDataset(n={self.num_examples}, shape={tuple(self.data.shape)}, "
            f"device={self.data.device})"
        )


def as_dataset(value: Any) -> Dataset:
    """Coerce lists/arrays/tensors into a Dataset."""
    if isinstance(value, Dataset):
        return value
    if isinstance(value, (list, tuple)):
        return ObjectDataset(list(value))
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return ArrayDataset(value)
    raise TypeError(f"cannot interpret {type(value)} as a Dataset")
