"""Data-driven node-level optimization.

Port of ``keystone_tpu/workflow/optimize.py``
(reference: workflow/NodeOptimizationRule.scala:14-198,
workflow/OptimizableNodes.scala:7-50). ``Optimizable`` operators inspect a
small sample of their input plus dataset statistics and swap themselves
for a concrete implementation.

The sample interpreter executes the node's ancestry with every bound
dataset subsampled to ``sample_size`` items — the analog of the
reference's ``SampleCollector`` mini-interpreter.

One departure from the JAX package: an ``optimize`` that raises
``UnportedRung`` (it picked a rung the port has not ported yet) fails the
plan instead of falling back to the operator's default. Every other
error, a bare ``NotImplementedError`` included, is logged and leaves the
default operator, as in the JAX package.

Left out for now: ``PartitionPlanRule``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..data.dataset import ArrayDataset, Dataset, ObjectDataset
from ..utils.tree import tree_map
from .graph import Graph, NodeId, SinkId, SourceId
from .operators import DatasetOperator, Operator, wrap_expression
from .rules import PrefixMap, Rule


@dataclass
class DataStats:
    """Statistics handed to ``Optimizable.optimize``."""

    n_total: int
    num_shards: int
    n_per_shard: List[int]


class UnportedRung(NotImplementedError):
    """An ``Optimizable`` picked an implementation the port lacks; running
    the default instead would quietly change the solver."""


class Optimizable:
    """Mixin for operators that can self-specialize from data statistics."""

    def optimize(self, samples: List[Dataset], stats: DataStats) -> Operator:
        """Return the concrete operator to use (may be ``self``)."""
        raise NotImplementedError


class NodeOptimizationRule(Rule):
    """Run samples through the plan; let Optimizable nodes pick an impl."""

    def __init__(self, sample_size: int = 100):
        self.sample_size = sample_size

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        optimizable = [
            n for n in sorted(graph.nodes) if isinstance(graph.get_operator(n), Optimizable)
        ]
        if not optimizable:
            return graph, prefixes

        sampler = _SampleInterpreter(graph, self.sample_size)
        for node in optimizable:
            op = graph.get_operator(node)
            try:
                samples = [sampler.execute(d) for d in graph.get_dependencies(node)]
                sample_datasets = [s for s in samples if isinstance(s, Dataset)]
                stats = sampler.stats_for(graph.get_dependencies(node))
                replacement = op.optimize(sample_datasets, stats)
            except UnportedRung:
                raise
            except Exception as e:  # sampling must never break planning
                logging.getLogger(__name__).warning(
                    "node optimization skipped for %s (%s): falling back to "
                    "the default operator", node, e,
                )
                continue
            if replacement is not op:
                graph = graph.set_operator(node, replacement)
        return graph, prefixes


class _SampleInterpreter:
    """Executes the graph with all bound datasets truncated to a sample."""

    def __init__(self, graph: Graph, sample_size: int):
        self.graph = graph
        self.sample_size = sample_size
        self._memo: Dict = {}
        self._full_sizes: Dict = {}

    def execute(self, graph_id):
        if graph_id in self._memo:
            return self._memo[graph_id]
        if isinstance(graph_id, SourceId):
            raise ValueError("cannot sample through an unbound source")
        if isinstance(graph_id, SinkId):
            return self.execute(self.graph.get_sink_dependency(graph_id))

        op = self.graph.get_operator(graph_id)
        if isinstance(op, DatasetOperator):
            full = op.dataset
            self._full_sizes[graph_id] = (len(full), full.num_shards)
            result = _subsample(full, self.sample_size)
        else:
            deps = [self.execute(d) for d in self.graph.get_dependencies(graph_id)]
            expressions = [wrap_expression(d) for d in deps]
            result = op.execute(expressions).get()
        self._memo[graph_id] = result
        return result

    def stats_for(self, dep_ids) -> DataStats:
        """Full-data statistics for a node's dependency subtree."""
        n_total, shards = 0, 1
        for dep in dep_ids:
            info = self._lookup_size(dep)
            if info is not None:
                n_total = max(n_total, info[0])
                shards = max(shards, info[1])
        base, extra = divmod(n_total, shards)
        return DataStats(
            n_total=n_total,
            num_shards=shards,
            n_per_shard=[base + (1 if i < extra else 0) for i in range(shards)],
        )

    def _lookup_size(self, graph_id) -> Optional[Tuple[int, int]]:
        if graph_id in self._full_sizes:
            return self._full_sizes[graph_id]
        if isinstance(graph_id, NodeId):
            for dep in self.graph.get_dependencies(graph_id):
                info = self._lookup_size(dep)
                if info is not None:
                    return info
        return None


def _subsample(dataset: Dataset, n: int) -> Dataset:
    if len(dataset) <= n:
        return dataset
    if isinstance(dataset, ArrayDataset):
        return ArrayDataset(tree_map(lambda a: a[:n], dataset.data), num_examples=n)
    return ObjectDataset(dataset.take(n))
