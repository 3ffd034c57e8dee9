"""Port of ``keystone_tpu.evaluation`` (binary and multiclass)."""

from .binary import BinaryClassificationMetrics, BinaryClassifierEvaluator
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = [
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
