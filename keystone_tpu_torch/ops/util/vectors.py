"""Vector conversion operators.

Port of ``keystone_tpu/ops/util/vectors.py::Densify``: sparse host rows
become one dense float32 tensor on an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...workflow.pipeline import Transformer


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
