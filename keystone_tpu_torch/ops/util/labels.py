"""Label encoding and argmax classification.

Port of ``keystone_tpu/ops/util/labels.py``: ``ClassLabelIndicators``
(int label → ±1 one-hot), ``MultiLabelIndicators`` (label lists → ±1
multi-hot), ``MaxClassifier`` (argmax) and ``TopKClassifier`` (indices of
the k largest scores, best first). The batched ones run on the device
their input tensor lives on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike
from ...workflow.pipeline import BatchTransformer, Transformer


class ClassLabelIndicators(BatchTransformer):
    """int label i → length-k vector of -1s with +1 at position i."""

    def __init__(self, num_classes: int):
        if num_classes <= 1:
            raise ValueError("num_classes must be > 1")
        self.num_classes = num_classes

    def apply_arrays(self, labels: torch.Tensor) -> torch.Tensor:
        labels = torch.as_tensor(labels).long()
        onehot = torch.full(
            (labels.shape[0], self.num_classes), -1.0,
            dtype=torch.float32, device=labels.device,
        )
        onehot[torch.arange(labels.shape[0], device=labels.device), labels] = 1.0
        return onehot


class MultiLabelIndicators(Transformer):
    """list of int labels → ±1 multi-hot vector; a batch lands on
    ``device`` (default CUDA)."""

    def __init__(self, num_classes: int, device: DeviceLike = None):
        if num_classes <= 1:
            raise ValueError("num_classes must be > 1")
        self.num_classes = num_classes
        self.device = device

    def apply(self, labels: Sequence[int]) -> np.ndarray:
        vec = np.full(self.num_classes, -1.0, dtype=np.float32)
        vec[np.asarray(list(labels), dtype=np.int64)] = 1.0
        return vec

    def apply_batch(self, dataset: Dataset) -> ArrayDataset:
        return ArrayDataset(np.stack([self.apply(i) for i in dataset.collect()]), device=self.device)


class MaxClassifier(BatchTransformer):
    """scores (n, k) → argmax int32 (n,); ties go to the first maximum."""

    def apply_arrays(self, scores: torch.Tensor) -> torch.Tensor:
        return torch.argmax(scores, dim=-1).to(torch.int32)


class TopKClassifier(BatchTransformer):
    """scores (n, c) → (n, k) int32 class indices, best first; among equal
    scores the lower index comes first, as ``lax.top_k`` orders them
    (``torch.topk`` leaves that order unspecified, so a stable descending
    sort takes its place)."""

    def __init__(self, k: int):
        self.k = k

    def apply_arrays(self, scores: torch.Tensor) -> torch.Tensor:
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
        return order[..., : self.k].to(torch.int32)
