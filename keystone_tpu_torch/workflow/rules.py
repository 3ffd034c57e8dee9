"""Rewrite-rule engine + the standard optimizer stack.

Port of ``keystone_tpu/workflow/rules.py``
(reference: workflow/Rule.scala:11-19, workflow/RuleExecutor.scala:5-88,
workflow/DefaultOptimizer.scala:8-26, workflow/EquivalentNodeMergeRule.scala:13-48,
workflow/UnusedBranchRemovalRule.scala:7-24, workflow/SavedStateLoadRule.scala:7-20,
workflow/ExtractSaveablePrefixes.scala:9-22).

Rules rewrite ``(Graph, prefix-map)`` pairs. The prefix map marks nodes whose
results should be persisted to the process-wide state table after execution,
enabling cross-pipeline reuse of fit estimator work.

:class:`RuleExecutor` publishes, as the JAX package does, the
``keystone_optimizer_rule_runs_total`` / ``_rule_rewrites_total``
counters per rule and the ``keystone_optimizer_seconds`` histogram, and
opens ``optimize:rules`` and ``optimize:batch:<name>`` spans (a
``rule_rewrite`` event per rewrite) under an active span session.

Left out for now: the ``measured-knobs`` and ``partition`` batches and
``auto_caching_optimizer``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import names as _names
from ..obs import spans as _spans
from .analysis import get_ancestors
from .graph import Graph, NodeId
from .operators import EstimatorOperator, ExpressionOperator
from .prefix import Prefix, find_prefix

logger = logging.getLogger(__name__)

PrefixMap = Dict[NodeId, Prefix]


class Rule:
    """One graph rewrite. Must be pure: returns new (graph, prefixes)."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        raise NotImplementedError


@dataclass
class Batch:
    """A named group of rules run once or to fixed point."""

    name: str
    rules: Sequence[Rule]
    fixed_point: bool = False
    max_iterations: int = 100


class RuleExecutor:
    """Runs batches in order; fixed-point batches iterate until stable."""

    def __init__(self, batches: Sequence[Batch]):
        self.batches = list(batches)

    def execute(self, graph: Graph, prefixes: Optional[PrefixMap] = None) -> Tuple[Graph, PrefixMap]:
        runs_c = _names.metric(_names.RULE_RUNS)
        rewrites_c = _names.metric(_names.RULE_REWRITES)
        prefixes = dict(prefixes or {})
        t0 = time.perf_counter()
        with _spans.span("optimize:rules", batches=len(self.batches)):
            for batch in self.batches:
                iterations = batch.max_iterations if batch.fixed_point else 1
                with _spans.span(f"optimize:batch:{batch.name}"):
                    for _ in range(iterations):
                        before = graph
                        for rule in batch.rules:
                            new_graph, prefixes = rule.apply(graph, prefixes)
                            runs_c.inc(rule=rule.name)
                            if new_graph != graph:
                                rewrites_c.inc(rule=rule.name)
                                _spans.add_span_event("rule_rewrite", rule=rule.name)
                                if logger.isEnabledFor(logging.DEBUG):
                                    logger.debug(
                                        "rule %s rewrote graph:\n%s", rule.name, new_graph.to_dot()
                                    )
                            graph = new_graph
                        if graph == before:
                            break
        _names.metric(_names.OPTIMIZE_SECONDS).observe(time.perf_counter() - t0)
        return graph, prefixes


# --------------------------------------------------------------------- rules


class EquivalentNodeMergeRule(Rule):
    """Common-subexpression elimination: merge nodes with equal operators and
    equal dependency lists, repeating until fixed point
    (reference: EquivalentNodeMergeRule.scala:13-48)."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        while True:
            groups: Dict[Tuple, List[NodeId]] = {}
            for node in sorted(graph.nodes):
                op = graph.get_operator(node)
                try:
                    key = (op, graph.get_dependencies(node))
                    groups.setdefault(key, []).append(node)
                except TypeError:  # unhashable operator: never merged
                    continue
            merged_any = False
            for key, nodes in groups.items():
                if len(nodes) < 2:
                    continue
                keep, rest = nodes[0], nodes[1:]
                for node in rest:
                    graph = graph.replace_dependency(node, keep)
                    graph = graph.remove_node(node)
                    prefixes.pop(node, None)
                merged_any = True
            if not merged_any:
                return graph, prefixes


class UnusedBranchRemovalRule(Rule):
    """Prune nodes and sources that no sink transitively depends on
    (reference: UnusedBranchRemovalRule.scala:7-24)."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        live = set()
        for sink in graph.sinks:
            live |= get_ancestors(graph, sink)
            live.add(graph.get_sink_dependency(sink))
        dead_nodes = [n for n in graph.nodes if n not in live]
        dead_sources = [s for s in graph.sources if s not in live]
        # Iteratively remove (a dead node may be referenced by another dead node).
        pending = set(dead_nodes)
        while pending:
            progressed = False
            for node in sorted(pending):
                try:
                    graph = graph.remove_node(node)
                except ValueError:
                    continue
                pending.discard(node)
                prefixes.pop(node, None)
                progressed = True
            if not progressed:  # pragma: no cover - cycle, should not happen
                break
        for source in dead_sources:
            try:
                graph = graph.remove_source(source)
            except ValueError:  # pragma: no cover
                pass
        return graph, prefixes


def _is_saveable(op) -> bool:
    from ..ops.util.misc import CacherOperator  # local import to avoid cycle

    return isinstance(op, (EstimatorOperator, CacherOperator))


class ExtractSaveablePrefixes(Rule):
    """Mark estimator and cacher nodes' prefixes for state-table persistence
    (reference: ExtractSaveablePrefixes.scala:9-22)."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        out = dict(prefixes)
        for node in graph.nodes:
            if _is_saveable(graph.get_operator(node)):
                prefix = find_prefix(graph, node)
                if prefix is not None:
                    out[node] = prefix
        return graph, out


class SavedStateLoadRule(Rule):
    """Replace nodes whose prefix already has a stored result with an
    ExpressionOperator splice (reference: SavedStateLoadRule.scala:7-20)."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        from .executor import PipelineEnv

        state = PipelineEnv.get_or_create().state
        for node, prefix in list(prefixes.items()):
            if prefix in state and node in graph.operators:
                graph = graph.set_operator(node, ExpressionOperator(state[prefix]))
                graph = graph.set_dependencies(node, [])
                del prefixes[node]
        return graph, prefixes


# ----------------------------------------------------------------- optimizer


def default_optimizer() -> RuleExecutor:
    """Saved-state reuse → CSE → node-level optimization → chain fusion →
    streaming, the JAX package's stack in its order without its last two
    batches (reference: DefaultOptimizer.scala:8-26). Fusion runs late so
    every structural decision upstream sees real node boundaries;
    streaming runs after it so it can absorb already-fused chains into
    chunked fit plans."""
    from .fusion import NodeFusionRule
    from .optimize import NodeOptimizationRule
    from .streaming import StreamingPlanRule

    return RuleExecutor(
        [
            Batch(
                "load-saved-state",
                [ExtractSaveablePrefixes(), SavedStateLoadRule(), UnusedBranchRemovalRule()],
            ),
            Batch("cse", [EquivalentNodeMergeRule()], fixed_point=True),
            Batch("node-level-optimization", [NodeOptimizationRule()]),
            Batch("fusion", [NodeFusionRule()]),
            Batch("streaming", [StreamingPlanRule()]),
        ]
    )
