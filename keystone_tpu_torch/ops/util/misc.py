"""Caching and shuffling utility operators.

Port of ``keystone_tpu/ops/util/misc.py``
(reference: nodes/util/Cacher.scala:15-25, nodes/util/Shuffler.scala:15-22).

"Caching" is a residency decision: ``hbm`` keeps the materialized batch
where it is (device memory); ``host`` moves it to CPU memory, freeing the
device for later stages. The level keeps the JAX package's name.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset, ObjectDataset
from ...utils.tree import tree_map
from ...workflow.operators import TransformerOperator


class CacherOperator(TransformerOperator):
    """Identity marker that pins its input at a storage level."""

    def __init__(self, name: str = "", level: str = "hbm"):
        if level not in ("hbm", "host"):
            raise ValueError(f"level must be 'hbm' or 'host', not {level!r}")
        self.name = name
        self.level = level

    @property
    def label(self) -> str:
        return f"Cache[{self.name or self.level}]"

    def single_transform(self, datums: List[Any]) -> Any:
        return datums[0]

    def batch_transform(self, datasets: List[Dataset]) -> Dataset:
        ds = datasets[0]
        if self.level == "host" and isinstance(ds, ArrayDataset):
            return ArrayDataset(tree_map(lambda a: a.cpu(), ds.data), ds.num_examples)
        return ds.cache()


class ShufflerOperator(TransformerOperator):
    """Random permutation of the example axis, drawn on the host with
    ``np.random.default_rng(seed)`` as in the JAX package
    (reference: nodes/util/Shuffler.scala:15-22)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def single_transform(self, datums: List[Any]) -> Any:
        return datums[0]

    def batch_transform(self, datasets: List[Dataset]) -> Dataset:
        ds = datasets[0]
        rng = np.random.default_rng(self.seed)
        if isinstance(ds, ArrayDataset):
            n = ds.num_examples
            perm = rng.permutation(n)
            data = tree_map(lambda a: a[:n][torch.as_tensor(perm, device=a.device)], ds.data)
            return ArrayDataset(data, n)
        items = ds.collect()
        rng.shuffle(items)
        return ObjectDataset(items)
