"""Sparse feature-space fitting and vectorization.

A copy of ``keystone_tpu/ops/util/sparse.py`` over the port's
``utils/sparse.csr_row`` (host scipy rows; nothing here touches a
device). Reference: nodes/util/CommonSparseFeatures.scala:19-76,
nodes/util/AllSparseFeatures.scala:15-32,
nodes/util/SparseFeatureVectorizer.scala:7-21. Inputs are per-document
``[(feature, value), ...]`` pairs (TermFrequency output); the fitted
transformer emits scipy CSR rows for the sparse solver path.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from ...data.dataset import Dataset
from ...utils.sparse import csr_row
from ...workflow.pipeline import Estimator, Transformer


class SparseFeatureVectorizer(Transformer):
    """(feature, value) pairs → CSR row over a fixed feature space; unknown
    features are dropped (reference: SparseFeatureVectorizer.scala:8-20)."""

    def __init__(self, feature_space: Dict[Any, int]):
        self.feature_space = feature_space

    def apply(self, pairs: Sequence[Tuple[Any, float]]):
        space = self.feature_space
        seen: Dict[int, float] = {}
        for feat, val in pairs:
            j = space.get(feat)
            if j is not None:
                seen[j] = seen.get(j, 0.0) + float(val)
        return csr_row(seen, len(space))


class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` most frequent features, ties broken by
    earliest appearance (reference: CommonSparseFeatures.scala:19-76)."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        counts: Dict[Any, int] = {}
        first_seen: Dict[Any, int] = {}
        order = 0
        for doc in data.collect():
            for feat, _val in doc:
                counts[feat] = counts.get(feat, 0) + 1
                if feat not in first_seen:
                    first_seen[feat] = order
                order += 1
        top = sorted(counts.items(), key=lambda kv: (-kv[1], first_seen[kv[0]]))
        space = {feat: i for i, (feat, _) in enumerate(top[: self.num_features])}
        return SparseFeatureVectorizer(space)


class AllSparseFeatures(Estimator):
    """Keep every observed feature, ordered by first appearance
    (reference: AllSparseFeatures.scala:15-32)."""

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        space: Dict[Any, int] = {}
        for doc in data.collect():
            for feat, _val in doc:
                if feat not in space:
                    space[feat] = len(space)
        return SparseFeatureVectorizer(space)


__all__ = ["AllSparseFeatures", "CommonSparseFeatures", "SparseFeatureVectorizer"]
