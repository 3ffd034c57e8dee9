"""Vector shaping / conversion operators.

Port of ``keystone_tpu/ops/util/vectors.py``:

- ``VectorCombiner`` — concatenate gathered branch outputs feature-wise.
- ``Densify`` — sparse host rows become one dense float32 tensor on an
  explicit device.

Left out for now: ``VectorSplitter``, ``Cast``, ``MatrixVectorizer`` and
``Sparsify``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...workflow.pipeline import BatchTransformer, Transformer


class VectorCombiner(BatchTransformer):
    """Concatenate a gathered tuple of (n, d_i) tensors into (n, Σd_i)."""

    def apply_arrays(self, data):
        if isinstance(data, (tuple, list)):
            return torch.cat([p.reshape(p.shape[0], -1) for p in data], dim=-1)
        return data

    def apply(self, datum):
        return torch.cat([torch.as_tensor(p).reshape(-1) for p in datum])


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

            dense = sp.vstack(items).toarray().astype(np.float32)
        else:
            dense = np.stack([self.apply(i) for i in items])
        return ArrayDataset(torch.from_numpy(dense), device=resolve_device(self.device))
