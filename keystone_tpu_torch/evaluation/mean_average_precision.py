"""VOC-style mean average precision.

Port of ``keystone_tpu/evaluation/mean_average_precision.py`` (reference:
evaluation/MeanAveragePrecisionEvaluator.scala:13-87), a host numpy copy:
per-class score ranking, cumulative tp/fp → precision/recall curve,
11-point interpolated AP (precision maxima at recall levels 0, 0.1, …,
1.0), as in the VOC2007 enceval toolkit. Scores may come as a tensor, an
``ArrayDataset`` or a lazy pipeline result; they are read into float64
on the host.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


class MeanAveragePrecisionEvaluator:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predicted_scores: Any, actual_labels: Any) -> np.ndarray:
        """predicted_scores: (n, num_classes) per-class scores;
        actual_labels: length-n sequence of label-id lists (multi-label).
        Returns per-class average precision (length num_classes)."""
        scores = _to_score_matrix(predicted_scores)
        labels = _to_label_lists(actual_labels)
        if scores.shape[0] != len(labels):
            raise ValueError("scores and labels differ in length")
        n, k = scores.shape
        gt = np.zeros((n, k), dtype=np.float64)
        for i, labs in enumerate(labels):
            for l in labs:
                gt[i, int(l)] = 1.0

        aps = np.zeros(k)
        for cl in range(k):
            order = np.argsort(-scores[:, cl], kind="stable")
            g = gt[order, cl]
            tps = np.cumsum(g)
            fps = np.cumsum(1.0 - g)
            total = g.sum()
            if total == 0:
                aps[cl] = 0.0
                continue
            recalls = tps / total
            precisions = tps / (tps + fps)
            aps[cl] = _eleven_point_ap(precisions, recalls)
        return aps

    def mean(self, aps: np.ndarray) -> float:
        return float(np.mean(aps))


def _eleven_point_ap(precisions: np.ndarray, recalls: np.ndarray) -> float:
    """Max precision at recall ≥ t for t in {0, 0.1, …, 1.0}, averaged
    (reference: MeanAveragePrecisionEvaluator.scala getAP:70-87)."""
    ap = 0.0
    for t in np.arange(11) / 10.0:
        px = precisions[recalls >= t]
        ap += (px.max() if px.size else 0.0) / 11.0
    return ap


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _to_score_matrix(x: Any) -> np.ndarray:
    if hasattr(x, "get"):
        x = x.get()
    if hasattr(x, "num_examples"):
        return _host(x.data[: x.num_examples])
    if hasattr(x, "collect"):
        return np.stack([_host(r) for r in x.collect()])
    return _host(x)


def _to_label_lists(x: Any) -> Sequence[Sequence[int]]:
    if hasattr(x, "get"):
        x = x.get()
    if hasattr(x, "collect"):
        return x.collect()
    return list(x)
