"""Branch-merging gather operator.

Port of ``keystone_tpu/ops/util/gather.py``
(reference: workflow/GatherTransformerOperator.scala:9,
workflow/Pipeline.scala:119-154). Per input item it emits the list of all
branch outputs; when every branch produced tensors the gathered form is
an ``ArrayDataset`` over a tuple of them, so ``VectorCombiner`` joins them
in one concatenation on the device. Branches that are ``BucketedDataset``s
with aligned buckets gather bucket by bucket.
"""

from __future__ import annotations

from typing import Any, List

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset, ObjectDataset
from ...utils.tree import tree_map
from ...workflow.operators import TransformerOperator


class GatherTransformer(TransformerOperator):
    @property
    def label(self) -> str:
        return "Gather"

    def single_transform(self, datums: List[Any]) -> Any:
        return list(datums)

    def batch_transform(self, datasets: List[Dataset]) -> Dataset:
        if all(isinstance(d, BucketedDataset) for d in datasets):
            counts = {tuple(len(b) for b in d.buckets) for d in datasets}
            if len(counts) == 1:  # aligned buckets: gather bucket-wise
                return BucketedDataset(
                    [self.batch_transform(list(bs)) for bs in zip(*(d.buckets for d in datasets))]
                )
        if all(isinstance(d, ArrayDataset) for d in datasets):
            n = min(d.num_examples for d in datasets)
            phys = min(d.physical_rows for d in datasets)
            data = tuple(
                tree_map(lambda a: a[:phys], d.data) if d.physical_rows != phys else d.data
                for d in datasets
            )
            return ArrayDataset(data, num_examples=n)
        collected = [d.collect() for d in datasets]
        return ObjectDataset([list(row) for row in zip(*collected)])
