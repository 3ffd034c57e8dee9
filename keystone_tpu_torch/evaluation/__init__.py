"""Port of ``keystone_tpu.evaluation`` (binary, multiclass, augmented examples)."""

from .augmented import AugmentedExamplesEvaluator
from .binary import BinaryClassificationMetrics, BinaryClassifierEvaluator
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = [
    "AugmentedExamplesEvaluator",
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
