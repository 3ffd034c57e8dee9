"""Evaluation over augmented example copies.

Port of ``keystone_tpu/evaluation/augmented.py`` (reference:
evaluation/AugmentedExamplesEvaluator.scala:9-71): predictions for
augmented copies of the same underlying example (identified by a name)
are aggregated per name by *average* score or *borda* rank-sum voting,
argmaxed, and scored with the multiclass evaluator, on the host.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics, _to_int_array


def _to_score_matrix(x: Any) -> np.ndarray:
    """(n, k) float64 host scores from a dataset, lazy result, tensor or array."""
    if hasattr(x, "get"):
        x = x.get()
    if hasattr(x, "num_examples"):
        x = x.data[: x.num_examples]
    elif hasattr(x, "collect"):
        x = x.collect()
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class AugmentedExamplesEvaluator:
    def __init__(self, names: Sequence[Any], num_classes: int, policy: str = "average"):
        if policy not in ("average", "borda"):
            raise ValueError("policy must be 'average' or 'borda'")
        self.names = list(names)
        self.num_classes = num_classes
        self.policy = policy

    def evaluate(self, predicted: Any, actual_labels: Any) -> MulticlassMetrics:
        scores = _to_score_matrix(predicted)  # (n_copies, k)
        labels = _to_int_array(actual_labels)
        if not (len(self.names) == scores.shape[0] == len(labels)):
            raise ValueError("names, predictions and labels must align")

        if self.policy == "borda":
            # rank of each class in ascending score order, per copy
            order = np.argsort(scores, axis=1, kind="stable")
            votes = np.empty_like(scores)
            ranks = np.broadcast_to(np.arange(scores.shape[1], dtype=np.float64), scores.shape)
            np.put_along_axis(votes, order, ranks.copy(), axis=1)
        else:
            votes = scores

        groups: dict[Any, list[int]] = {}
        for i, name in enumerate(self.names):
            groups.setdefault(name, []).append(i)

        final_preds, final_actuals = [], []
        for name, idx in groups.items():
            group_labels = labels[idx]
            if len(set(group_labels.tolist())) != 1:
                raise ValueError(f"conflicting labels for augmented copies of {name!r}")
            agg = votes[idx].sum(axis=0)
            if self.policy == "average":
                agg = agg / len(idx)
            final_preds.append(int(np.argmax(agg)))
            final_actuals.append(int(group_labels[0]))

        return MulticlassClassifierEvaluator(self.num_classes).evaluate(
            np.asarray(final_preds), np.asarray(final_actuals)
        )
