"""Binary classification metrics from a contingency table.

Port of ``keystone_tpu/evaluation/binary.py``. Reference: evaluation/BinaryClassifierEvaluator.scala:17-79 — one pass over
zipped prediction/actual booleans into tp/fp/tn/fn, with derived
accuracy/precision/recall/specificity/fβ. Here the pass is a vectorized
host count over the whole batch (predictions and actuals arrive as
datasets, lazy pipeline results, tensors or arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .multiclass import _to_int_array


@dataclass
class BinaryClassificationMetrics:
    tp: float
    fp: float
    tn: float
    fn: float

    def merge(self, other: "BinaryClassificationMetrics") -> "BinaryClassificationMetrics":
        return BinaryClassificationMetrics(
            self.tp + other.tp, self.fp + other.fp, self.tn + other.tn, self.fn + other.fn
        )

    @property
    def accuracy(self) -> float:
        return _ratio(self.tp + self.tn, self.tp + self.fp + self.tn + self.fn)

    @property
    def error(self) -> float:
        return _ratio(self.fp + self.fn, self.tp + self.fp + self.tn + self.fn)

    @property
    def recall(self) -> float:
        return _ratio(self.tp, self.tp + self.fn)

    @property
    def precision(self) -> float:
        return _ratio(self.tp, self.tp + self.fp)

    @property
    def specificity(self) -> float:
        return _ratio(self.tn, self.fp + self.tn)

    def f_score(self, beta: float = 1.0) -> float:
        num = (1.0 + beta * beta) * self.tp
        denom = (1.0 + beta * beta) * self.tp + beta * beta * self.fn + self.fp
        return _ratio(num, denom)

    def summary(self) -> str:
        return (
            f"Accuracy:\t{self.accuracy:2.3f}\n"
            f"Precision:\t{self.precision:2.3f}\n"
            f"Recall:\t{self.recall:2.3f}\n"
            f"Specificity:\t{self.specificity:2.3f}\n"
            f"F1:\t{self.f_score():2.3f}"
        )


def _ratio(num: float, denom: float) -> float:
    """NaN on empty denominators, matching JVM double division semantics
    (the reference's 0/0 yields NaN, not an exception)."""
    return num / denom if denom != 0 else float("nan")


class BinaryClassifierEvaluator:
    def evaluate(self, predictions: Any, actuals: Any) -> BinaryClassificationMetrics:
        pred = _to_int_array(predictions).astype(bool)
        act = _to_int_array(actuals).astype(bool)
        if len(pred) != len(act):
            raise ValueError("predictions and actuals differ in length")
        return BinaryClassificationMetrics(
            tp=float(np.sum(pred & act)),
            fp=float(np.sum(pred & ~act)),
            tn=float(np.sum(~pred & ~act)),
            fn=float(np.sum(~pred & act)),
        )


__all__ = ["BinaryClassificationMetrics", "BinaryClassifierEvaluator"]
