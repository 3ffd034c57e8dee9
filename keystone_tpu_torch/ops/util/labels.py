"""Label encoding and argmax classification.

Port of ``keystone_tpu/ops/util/labels.py``: ``ClassLabelIndicators``
(int label → ±1 one-hot) and ``MaxClassifier`` (argmax). Both run on the
device their input tensor lives on.
"""

from __future__ import annotations

import torch

from ...workflow.pipeline import BatchTransformer


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


class MaxClassifier(BatchTransformer):
    """scores (n, k) → argmax int32 (n,); ties go to the first maximum."""

    def apply_arrays(self, scores: torch.Tensor) -> torch.Tensor:
        return torch.argmax(scores, dim=-1).to(torch.int32)
