"""Multiclass evaluation: confusion matrix + macro/micro metrics.

Port of ``keystone_tpu/evaluation/multiclass.py``. Predictions and
labels arrive as datasets, lazy pipeline results, tensors or arrays; the
confusion matrix is a host numpy scatter-add.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch


@dataclass
class MulticlassMetrics:
    confusion_matrix: np.ndarray  # (k, k) rows=actual, cols=predicted

    @property
    def num_classes(self) -> int:
        return self.confusion_matrix.shape[0]

    @property
    def total(self) -> int:
        return int(self.confusion_matrix.sum())

    @property
    def total_accuracy(self) -> float:
        return float(np.trace(self.confusion_matrix)) / max(self.total, 1)

    @property
    def total_error(self) -> float:
        return 1.0 - self.total_accuracy

    # ------------------------------------------------------------- per class
    def class_precision(self) -> np.ndarray:
        cm = self.confusion_matrix
        denom = cm.sum(axis=0)
        return np.where(denom > 0, np.diag(cm) / np.maximum(denom, 1), 0.0)

    def class_recall(self) -> np.ndarray:
        cm = self.confusion_matrix
        denom = cm.sum(axis=1)
        return np.where(denom > 0, np.diag(cm) / np.maximum(denom, 1), 0.0)

    def class_f1(self) -> np.ndarray:
        p, r = self.class_precision(), self.class_recall()
        return np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-12), 0.0)

    # ----------------------------------------------------------------- macro
    @property
    def macro_precision(self) -> float:
        return float(self.class_precision().mean())

    @property
    def macro_recall(self) -> float:
        return float(self.class_recall().mean())

    @property
    def macro_f1(self) -> float:
        return float(self.class_f1().mean())

    # ----------------------------------------------------------------- micro
    @property
    def micro_precision(self) -> float:
        return self.total_accuracy

    @property
    def micro_recall(self) -> float:
        return self.total_accuracy

    @property
    def micro_f1(self) -> float:
        return self.total_accuracy

    def summary(self, class_names: List[str] | None = None) -> str:
        names = class_names or [str(i) for i in range(self.num_classes)]
        lines = [
            f"Total accuracy: {self.total_accuracy:.4f}  error: {self.total_error:.4f}",
            f"Macro precision {self.macro_precision:.4f}  recall {self.macro_recall:.4f}  F1 {self.macro_f1:.4f}",
            f"Micro F1 {self.micro_f1:.4f}",
            "Per-class (precision / recall / f1):",
        ]
        p, r, f1 = self.class_precision(), self.class_recall(), self.class_f1()
        for i, name in enumerate(names):
            lines.append(f"  {name}: {p[i]:.4f} / {r[i]:.4f} / {f1[i]:.4f}")
        return "\n".join(lines)


class MulticlassClassifierEvaluator:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predictions: Any, labels: Any) -> MulticlassMetrics:
        pred = _to_int_array(predictions)
        lab = _to_int_array(labels)
        if len(pred) != len(lab):
            raise ValueError(
                f"predictions ({len(pred)}) and labels ({len(lab)}) differ in "
                "length — misaligned splits or unstripped padding rows"
            )
        k = self.num_classes
        for name, arr in (("labels", lab), ("predictions", pred)):
            if len(arr) and (arr.min() < 0 or arr.max() >= k):
                raise ValueError(
                    f"{name} outside [0, {k}): found range "
                    f"[{arr.min()}, {arr.max()}]"
                )
        cm = np.zeros((k, k), dtype=np.int64)
        np.add.at(cm, (lab, pred), 1)
        return MulticlassMetrics(cm)


def _to_int_array(x: Any) -> np.ndarray:
    if hasattr(x, "get"):  # PipelineResult
        x = x.get()
    if hasattr(x, "num_examples"):  # ArrayDataset
        x = x.data[: x.num_examples]
    elif hasattr(x, "collect"):
        x = x.collect()
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64).ravel()
