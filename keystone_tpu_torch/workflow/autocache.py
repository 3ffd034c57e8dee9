"""Profile-driven automatic caching: the device-residency planner.

Port of ``keystone_tpu/workflow/autocache.py``, a re-design of the
reference's AutoCacheRule
(reference: workflow/AutoCacheRule.scala:12-664, workflow/WeightedNode.scala,
workflow/WeightedOperator.scala, workflow/DefaultOptimizer.scala:17-26).

The reference profiles candidate nodes by executing scaled samples (2 and 4
items per partition), times them, reads RDD storage sizes, extrapolates both
metrics to full scale with per-metric linear fits, then greedily selects the
cache set that minimizes estimated total runtime under a cluster-memory
budget (default 75% of free executor memory) and splices ``Cacher`` nodes in.

On the card "caching" is a device-residency decision: a cached
intermediate (a ``CacherOperator(level="hbm")``, the JAX package's level
name) stays materialized in the card's memory between uses instead of
being recomputed by every downstream pull. The same profile →
linear-extrapolate → greedy-knapsack pipeline applies, with the budget
75% of the card's free memory (:func:`device_memory_budget_bytes`,
``torch.cuda.mem_get_info`` on the plan's device), and node weights
(``operator.weight``, e.g. 3·num_iter+1 for the block solver)
multiplying the recomputation count exactly as the reference's
``WeightedNode`` does. Each profiled node's timing waits for the device
(``torch.cuda.synchronize``) before it reads the clock.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from ..data.dataset import ArrayDataset, Dataset, ObjectDataset
from ..obs import cost as _cost
from ..obs import names as _names
from ..obs import spans as _spans
from ..obs import store as _store
from ..utils.tree import tree_leaves, tree_map
from .analysis import get_ancestors
from .graph import Graph, NodeId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    EstimatorOperator,
    Expression,
    Operator,
    wrap_expression,
)
from .rules import PrefixMap, Rule


@dataclass
class Profile:
    """Extrapolated full-scale execution profile of one node
    (reference: AutoCacheRule.scala ``Profile``)."""

    run_time_s: float
    size_bytes: int

    def __add__(self, other: "Profile") -> "Profile":
        return Profile(self.run_time_s + other.run_time_s, self.size_bytes + other.size_bytes)


@dataclass
class SampleProfile:
    """One measured (scale, time, bytes) observation
    (reference: AutoCacheRule.scala ``SampleProfile``)."""

    scale: int
    run_time_s: float
    size_bytes: int


def _operator_weight(op: Operator) -> int:
    """Number of passes the operator makes over its inputs
    (reference: WeightedOperator.scala; e.g. BCD weight = 3·numIter+1)."""
    w = getattr(op, "weight", 1)
    try:
        return max(1, int(w))
    except (TypeError, ValueError):
        return 1


def _estimate_bytes(value) -> int:
    """Materialized size of a node output."""
    if isinstance(value, ArrayDataset):
        return sum(a.numel() * a.element_size() for a in tree_leaves(value.data))
    if isinstance(value, ObjectDataset):
        total = 0
        for item in value.collect():
            if isinstance(item, np.ndarray):
                total += item.nbytes
            elif isinstance(item, (bytes, str)):
                total += len(item)
            else:
                total += 64  # flat object estimate, matches SizeEstimator's role
        return total
    return 64


def _fit_linear_coeffs(
    samples: List[SampleProfile],
) -> Tuple[float, float, float, float]:
    """Per-metric linear-fit coefficients ``(t0, t1, b0, b1)`` in scale —
    the REUSABLE form of a profile: plain floats that JSON-round-trip
    exactly, so a profile persisted by one process evaluates to the
    byte-identical :class:`Profile` in the next."""
    if len(samples) == 1:
        s = samples[0]
        scale = max(1, s.scale)
        return (0.0, s.run_time_s / scale, 0.0, s.size_bytes / scale)
    xs = np.array([[1.0, s.scale] for s in samples])
    times = np.array([s.run_time_s for s in samples])
    sizes = np.array([float(s.size_bytes) for s in samples])
    t_coef, *_ = np.linalg.lstsq(xs, times, rcond=None)
    s_coef, *_ = np.linalg.lstsq(xs, sizes, rcond=None)
    return (
        float(t_coef[0]), float(t_coef[1]), float(s_coef[0]), float(s_coef[1])
    )


def _profile_from_coeffs(
    coeffs: Tuple[float, float, float, float], full_n: int
) -> Profile:
    t = coeffs[0] + coeffs[1] * full_n
    b = coeffs[2] + coeffs[3] * full_n
    return Profile(max(t, 0.0), max(int(b), 0))


def _fit_linear(samples: List[SampleProfile], full_n: int) -> Profile:
    """Per-metric linear fit in scale, evaluated at full scale
    (reference: AutoCacheRule.scala:104-135 ``X \\ y``)."""
    return _profile_from_coeffs(_fit_linear_coeffs(samples), full_n)


class _ProfilingInterpreter:
    """Executes the plan with bound datasets truncated to ``scale`` rows,
    timing each node (the analog of the reference's per-node sample
    profiling, AutoCacheRule.scala:153-465)."""

    def __init__(self, graph: Graph, scale: int, clock=time.perf_counter):
        self.graph = graph
        self.scale = scale
        self.clock = clock
        self.times: Dict[NodeId, float] = {}
        self.sizes: Dict[NodeId, int] = {}
        self._memo: Dict = {}

    def execute(self, graph_id):
        if graph_id in self._memo:
            return self._memo[graph_id]
        if isinstance(graph_id, SourceId):
            raise ValueError("unbound source")
        if isinstance(graph_id, SinkId):
            return self.execute(self.graph.get_sink_dependency(graph_id))
        op = self.graph.get_operator(graph_id)
        if isinstance(op, DatasetOperator):
            result = _truncate(op.dataset, self.scale)
        else:
            deps = [self.execute(d) for d in self.graph.get_dependencies(graph_id)]
            expressions = [wrap_expression(d) for d in deps]
            start = self.clock()
            result = op.execute(expressions).get()
            _block(result)
            self.times[graph_id] = self.clock() - start
            if isinstance(result, Dataset):
                self.sizes[graph_id] = _estimate_bytes(result)
        self._memo[graph_id] = result
        return result


def _truncate(dataset: Dataset, n: int) -> Dataset:
    if len(dataset) <= n:
        return dataset
    if isinstance(dataset, ArrayDataset):
        return ArrayDataset(tree_map(lambda a: a[:n], dataset.data), num_examples=n)
    return ObjectDataset(dataset.take(n))


def _block(value) -> None:
    """Wait for the device work behind ``value`` so timings are real."""
    if isinstance(value, ArrayDataset):
        for leaf in tree_leaves(value.data):
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
                return


def _plan_device(graph: Graph) -> torch.device:
    """The device the plan's bound data lies on (the first tensor leaf of
    a bound dataset; the CPU when none holds a tensor)."""
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        if isinstance(op, DatasetOperator) and isinstance(op.dataset, ArrayDataset):
            for leaf in tree_leaves(op.dataset.data):
                if isinstance(leaf, torch.Tensor):
                    return leaf.device
    return torch.device("cpu")


def device_memory_budget_bytes(device: torch.device, fraction: float = 0.75) -> int:
    """Residency budget on ``device``: ``fraction`` of the card's free
    memory (the reference's 75%-of-free default cache budget,
    AutoCacheRule.scala:572-585), or of a 4 GB stand-in on the host, as
    the JAX package's CPU meshes use."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * fraction)
    return int(4e9 * fraction)


class AutoCacheRule(Rule):
    """Insert ``CacherOperator`` nodes minimizing estimated runtime under a
    device-memory budget (reference: AutoCacheRule.scala:12-664)."""

    def __init__(
        self,
        budget_bytes: Optional[int] = None,
        strategy: str = "greedy",
        profile_scales: Tuple[int, ...] = (2, 4),
        num_trials: int = 1,
        clock=time.perf_counter,
        profile_store="auto",
    ):
        assert strategy in ("greedy", "aggressive")
        self.budget_bytes = budget_bytes
        self.strategy = strategy
        self.profile_scales = profile_scales
        self.num_trials = num_trials
        # Injectable timer: profile-driven tests replace the wall clock
        # with a deterministic fake so cache choices don't depend on
        # machine load.
        self.clock = clock
        # Persistent profile store: "auto" uses
        # the process store (None when KEYSTONE_PROFILE_STORE=off), None
        # disables warm-starting for this rule, an instance pins one.
        self.profile_store = profile_store

    def _store(self):
        if self.profile_store == "auto":
            return _store.get_store()
        return self.profile_store

    # ------------------------------------------------------------- structure
    def _dependents(self, graph: Graph) -> Dict[NodeId, List]:
        """node → list of (dependent node-or-sink) — the shared
        :meth:`Graph.dependents` view, also used by the fusion pass."""
        return graph.dependents()

    def _candidates(self, graph: Graph, dependents: Dict[NodeId, List]) -> List[NodeId]:
        """Nodes worth caching: dataset-producing, used more than once when
        downstream weights are counted (reference: AutoCacheRule.scala
        ``nodesToCache`` — reused non-cached dataset outputs)."""
        from ..ops.util.misc import CacherOperator

        result = []
        for node in sorted(graph.nodes):
            op = graph.get_operator(node)
            if isinstance(op, (DatasetOperator, DatumOperator, CacherOperator, EstimatorOperator)):
                continue
            deps = dependents[node]
            uses = 0
            for d in deps:
                if isinstance(d, SinkId):
                    uses += 1
                else:
                    child_op = graph.get_operator(d)
                    if isinstance(child_op, CacherOperator):
                        uses = 0  # already cached
                        break
                    uses += _operator_weight(child_op)
            if uses > 1:
                result.append(node)
        return result

    # ------------------------------------------------------------- profiling
    def _profiled_nodes(self, graph: Graph) -> List[NodeId]:
        """The nodes sample-profiling will time: SOURCE-FREE operator
        nodes in the ancestry of any sink. Source-dependent branches (the
        delegating apply path of a ``with_data`` pipeline) are excluded
        rather than aborting the whole profile — the fit-cost subgraph is
        exactly the source-free part."""
        live: set = set()
        for sink in graph.sinks:
            live |= get_ancestors(graph, sink)
            live.add(graph.get_sink_dependency(sink))
        out: List[NodeId] = []
        for node in sorted(n for n in live if isinstance(n, NodeId)):
            if any(
                isinstance(a, SourceId) for a in get_ancestors(graph, node)
            ):
                continue
            if isinstance(graph.get_operator(node), DatasetOperator):
                continue
            out.append(node)
        return out

    def _node_digests(
        self, graph: Graph, nodes: List[NodeId]
    ) -> Optional[Dict[NodeId, str]]:
        """Cross-process stable digest per node (structural prefix +
        content-hashed operator state — the checkpoint layer's key), or
        None when any node can't be digested (store is then skipped)."""
        from ..reliability.checkpoint import prefix_digest, token_memo
        from .prefix import find_prefix

        digests: Dict[NodeId, str] = {}
        try:
            # One memo for the whole pass: every prefix re-tokenizes the
            # same DatasetOperator, and without the memo each node pays a
            # full content hash of the training data.
            with token_memo():
                for node in nodes:
                    prefix = find_prefix(graph, node)
                    if prefix is None:
                        return None
                    digests[node] = prefix_digest(prefix)
        except Exception:
            return None
        return digests

    def _profile(self, graph: Graph) -> Dict[NodeId, Profile]:
        """Profile EVERY executed node, not just cache candidates: caching a
        shared node also saves recomputing its whole (possibly expensive)
        ancestry, and the cost model must see those ancestor times.

        With a persistent profile store attached, a plan whose every node
        has a fresh stored profile (same structural digest, shape class,
        backend, environment fingerprint, and full row count) skips
        sample execution entirely and rebuilds byte-identical profiles
        from the stored linear-fit coefficients; a cold plan records its
        coefficients back so the NEXT process skips."""
        full_n = max(
            (len(graph.get_operator(n).dataset) for n in graph.nodes
             if isinstance(graph.get_operator(n), DatasetOperator)),
            default=0,
        )
        if full_n == 0:
            return {}
        targets = self._profiled_nodes(graph)
        if not targets:
            return {}

        store = self._store()
        digests: Optional[Dict[NodeId, str]] = None
        sc = _store.shape_class(full_n)
        if store is not None:
            digests = self._node_digests(graph, targets)
        if store is not None and digests is not None:
            warm: Optional[Dict[NodeId, Profile]] = {}
            for node in targets:
                m = store.lookup(f"autocache:{digests[node]}", sc)
                # An entry only covers this plan when it was measured
                # under the SAME profiling config: coefficients fit from
                # different sample scales/trial counts are different
                # measurements, and reusing them would make a
                # reconfigured rule silently inert.
                if (
                    m is None
                    or m.get("full_n") != full_n
                    or m.get("scales") != str(self.profile_scales)
                    or m.get("trials") != self.num_trials
                ):
                    warm = None
                    break
                warm[node] = _profile_from_coeffs(
                    (m["t0"], m["t1"], m["b0"], m["b1"]), full_n
                )
            if warm is not None:
                _spans.add_span_event(
                    "autocache_profile_store", nodes=len(warm), full_n=full_n
                )
                self._note_predictions(graph, warm, digests, sc)
                return warm

        samples: Dict[NodeId, List[SampleProfile]] = {}
        t_profile = time.perf_counter()
        with _spans.span(
            "autocache:profile", scales=str(self.profile_scales), full_n=full_n
        ):
            for scale in self.profile_scales:
                for _ in range(self.num_trials):
                    interp = _ProfilingInterpreter(graph, scale, clock=self.clock)
                    try:
                        for node in targets:
                            interp.execute(node)
                    except Exception as e:
                        # unbound sources etc.: no profile, no caching
                        logging.getLogger(__name__).warning(
                            "auto-cache profiling failed (%s): running without "
                            "cache planning", e,
                        )
                        return {}
                    for n, t in interp.times.items():
                        samples.setdefault(n, []).append(
                            SampleProfile(scale, t, interp.sizes.get(n, 0))
                        )
        _names.metric(_names.AUTOCACHE_PROFILE_SECONDS).observe(
            time.perf_counter() - t_profile
        )
        coeffs = {n: _fit_linear_coeffs(obs) for n, obs in samples.items() if obs}
        profiles = {
            n: _profile_from_coeffs(c, full_n) for n, c in coeffs.items()
        }
        if store is not None and digests is not None:
            for n, c in coeffs.items():
                store.record(
                    f"autocache:{digests[n]}",
                    sc,
                    full_n=full_n,
                    scales=str(self.profile_scales),
                    trials=self.num_trials,
                    t0=c[0], t1=c[1], b0=c[2], b1=c[3],
                    run_time_s=profiles[n].run_time_s,
                    size_bytes=profiles[n].size_bytes,
                )
        self._note_predictions(graph, profiles, digests, sc)
        return profiles

    def _note_predictions(
        self,
        graph: Graph,
        profiles: Dict[NodeId, Profile],
        digests: Optional[Dict[NodeId, str]],
        sc: str,
    ) -> None:
        """Publish each profiled node's predicted full-scale runtime into
        the cost observatory's plan book (obs/cost.py) — the ledger
        joins them to the measured walls ``timed_execute`` records, and
        the drift sentinel scores them (a warm-started profile is the
        canonical silent-staleness hazard: it skips re-measurement
        entirely). Label-keyed best-effort attribution; no-op when the
        observatory is off."""
        if digests is None or not _cost.cost_observatory_enabled():
            return
        for node, profile in profiles.items():
            digest = digests.get(node)
            if digest is None:
                continue
            op = graph.get_operator(node)
            _cost.note_plan_prediction(
                str(getattr(op, "label", type(op).__name__)),
                _cost.Prediction(
                    model="autocache",
                    key=f"autocache:{digest}",
                    shape=sc,
                    seconds=profile.run_time_s,
                    calibrated=True,
                ),
            )

    # ------------------------------------------------------------- cost model
    def _estimate_runtime(
        self,
        graph: Graph,
        dependents: Dict[NodeId, List],
        profiles: Dict[NodeId, Profile],
        cached: Set[NodeId],
    ) -> float:
        """Σ runs(n)·time(n) where runs counts weighted recomputations
        (reference: AutoCacheRule.scala ``estimateCachedRunTime``/``getRuns``)."""
        runs: Dict[NodeId, float] = {}

        def get_runs(node: NodeId) -> float:
            if node in runs:
                return runs[node]
            total = 0.0
            for d in dependents.get(node, []):
                if isinstance(d, SinkId):
                    total += 1.0
                else:
                    total += get_runs(d) * _operator_weight(graph.get_operator(d))
            total = max(total, 1.0)
            if node in cached:
                total = 1.0
            runs[node] = total
            return total

        return sum(get_runs(n) * p.run_time_s for n, p in profiles.items())

    def _greedy_select(
        self,
        graph: Graph,
        dependents: Dict[NodeId, List],
        profiles: Dict[NodeId, Profile],
        candidates: List[NodeId],
        budget: int,
    ) -> Set[NodeId]:
        """Greedy knapsack: repeatedly cache the node with the best
        runtime-saving that still fits (reference: AutoCacheRule.scala
        ``greedyCache``)."""
        cached: Set[NodeId] = set()
        used = 0
        remaining = {n for n in candidates if n in profiles}
        current = self._estimate_runtime(graph, dependents, profiles, cached)
        while remaining:
            best, best_time = None, current
            for n in sorted(remaining):
                if used + profiles[n].size_bytes > budget:
                    continue
                t = self._estimate_runtime(graph, dependents, profiles, cached | {n})
                if t < best_time:
                    best, best_time = n, t
            if best is None:
                break
            cached.add(best)
            used += profiles[best].size_bytes
            current = best_time
            remaining.discard(best)
        return cached

    # --------------------------------------------------------------- rewrite
    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        from ..ops.util.misc import CacherOperator
        from .fusion import FusedTransformerOperator

        # Ordering contract: cache planning must see
        # REAL node boundaries — the standard stacks run fusion strictly
        # after this rule, keeping cache decisions byte-identical to
        # pre-fusion plans. A custom stack that fused first would have
        # this planner profiling synthetic merged nodes (it still works,
        # but candidate boundaries inside fused chains are gone) — warn
        # so the mis-ordering is visible.
        if any(
            isinstance(op, FusedTransformerOperator)
            for op in graph.operators.values()
        ):
            logging.getLogger(__name__).warning(
                "AutoCacheRule running on an already-fused graph: cache "
                "planning cannot see boundaries inside fused chains; run "
                "fusion after auto-cache (the default optimizer ordering)"
            )

        dependents = self._dependents(graph)
        candidates = self._candidates(graph, dependents)
        if not candidates:
            return graph, prefixes

        if self.strategy == "aggressive":
            selected = set(candidates)
        else:
            profiles = self._profile(graph)
            if not profiles:
                return graph, prefixes
            budget = (
                self.budget_bytes
                if self.budget_bytes is not None
                else device_memory_budget_bytes(_plan_device(graph))
            )
            selected = self._greedy_select(graph, dependents, profiles, candidates, budget)

        if selected:
            _names.metric(_names.AUTOCACHE_CACHED_NODES).inc(len(selected))
            _spans.add_span_event(
                "autocache_selected",
                nodes=len(selected),
                strategy=self.strategy,
            )
        for node in sorted(selected):
            graph = _insert_cacher_after(graph, node, CacherOperator(level="hbm"))
        return graph, prefixes


def _insert_cacher_after(graph: Graph, node: NodeId, cacher) -> Graph:
    """Splice ``node -> cacher`` and repoint every other consumer of ``node``
    at the cacher (reference: AutoCacheRule.scala ``addCachesToPipeline``)."""
    graph, cache_node = graph.add_node(cacher, [node])
    for other in list(graph.nodes):
        if other == cache_node:
            continue
        deps = graph.get_dependencies(other)
        if node in deps:
            graph = graph.set_dependencies(
                other, [cache_node if d == node else d for d in deps]
            )
    for sink in graph.sinks:
        if graph.get_sink_dependency(sink) == node:
            graph = graph.set_sink_dependency(sink, cache_node)
    return graph
