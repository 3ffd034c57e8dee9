"""Vector shaping / conversion operators.

Port of ``keystone_tpu/ops/util/vectors.py``:

- ``VectorCombiner`` — concatenate gathered branch outputs feature-wise.
- ``VectorSplitter`` — split an (n, d) dataset into feature blocks, each
  a column view of the same tensor (no copy).
- ``Densify`` — sparse host rows become one dense float32 tensor on an
  explicit device. The CSR rows are cast to float32 before they are
  densified, so the host holds the dense matrix once, in float32.
- ``Cast`` — dtype conversion; ``FloatToDouble`` is the name-parity
  alias, and casts to float32 as the JAX package's does.
- ``MatrixVectorizer`` — flatten per-item matrices, (n, r, c) → (n, r·c).
- ``Sparsify`` — dense rows become host scipy CSR rows (1, d), the sparse
  solver path's input.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset, ObjectDataset
from ...device import DeviceLike, resolve_device
from ...utils.tree import tree_map
from ...workflow.pipeline import BatchTransformer, Transformer


class VectorCombiner(BatchTransformer):
    """Concatenate a gathered tuple of (n, d_i) tensors into (n, Σd_i)."""

    def apply_arrays(self, data):
        if isinstance(data, (tuple, list)):
            return torch.cat([p.reshape(p.shape[0], -1) for p in data], dim=-1)
        return data

    def apply(self, datum):
        return torch.cat([torch.as_tensor(p).reshape(-1) for p in datum])


class VectorSplitter(Transformer):
    """Split an (n, d) dataset into feature blocks [(n, b), ...].

    The reference materializes ``Seq[RDD[DenseVector]]``; here a block is a
    column view of the same tensor, so no copy happens until a solver
    touches the block.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size

    def split(self, dataset: Dataset) -> List[ArrayDataset]:
        ds = dataset if isinstance(dataset, ArrayDataset) else dataset.to_arrays()  # type: ignore[attr-defined]
        x = ds.data
        d = x.shape[1]
        return [
            ArrayDataset(x[:, start : min(start + self.block_size, d)], ds.num_examples)
            for start in range(0, d, self.block_size)
        ]

    def apply(self, datum):
        vec = datum if isinstance(datum, torch.Tensor) else np.asarray(datum)
        return [vec[s : s + self.block_size] for s in range(0, len(vec), self.block_size)]

    def apply_batch(self, dataset: Dataset) -> ObjectDataset:
        return ObjectDataset(self.split(dataset))


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, its name, or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class Cast(BatchTransformer):
    """Dtype conversion of every tensor of a batch."""

    def __init__(self, dtype):
        self.dtype = _torch_dtype(dtype)

    @property
    def label(self) -> str:
        return f"Cast[{str(self.dtype).replace('torch.', '')}]"

    def apply_arrays(self, data):
        return tree_map(lambda a: a.to(self.dtype), data)


class FloatToDouble(Cast):
    """Name-parity alias (reference: nodes/util/FloatToDouble.scala). It
    casts to float32, as the JAX package's does: the solvers run in
    float32."""

    def __init__(self):
        super().__init__(torch.float32)


class MatrixVectorizer(BatchTransformer):
    """Flatten per-item matrices: (n, r, c) → (n, r·c)."""

    def apply_arrays(self, x):
        return x.reshape(x.shape[0], -1)


class Densify(Transformer):
    """Sparse host dataset → dense tensor on ``device`` (default CUDA)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def apply(self, datum):
        if hasattr(datum, "toarray"):  # scipy sparse
            return np.asarray(datum.toarray()).ravel()
        return np.asarray(datum)

    def apply_batch(self, dataset: Dataset) -> ArrayDataset:
        if isinstance(dataset, ArrayDataset):
            return dataset
        items = dataset.collect()
        if items and hasattr(items[0], "toarray"):
            import scipy.sparse as sp

            # float32 before toarray(): the text featurizers' rows are
            # float64 CSR, and densifying first would hold the matrix on
            # the host twice over (values are counts, exact in float32).
            dense = sp.vstack(items, format="csr").astype(np.float32).toarray()
        else:
            dense = np.stack([self.apply(i) for i in items])
        return ArrayDataset(torch.from_numpy(dense), device=resolve_device(self.device))


class Sparsify(Transformer):
    """Dense dataset → host CSR rows (for the sparse solver path)."""

    def apply(self, datum):
        import scipy.sparse as sp

        if isinstance(datum, torch.Tensor):
            datum = datum.cpu().numpy()
        return sp.csr_matrix(np.asarray(datum).reshape(1, -1))

    def apply_batch(self, dataset: Dataset) -> ObjectDataset:
        import scipy.sparse as sp

        if isinstance(dataset, ArrayDataset):
            mat = sp.csr_matrix(dataset.data[: dataset.num_examples].cpu().numpy())
            return ObjectDataset([mat[i] for i in range(mat.shape[0])])
        return ObjectDataset([self.apply(i) for i in dataset.collect()])
