"""Whole-pipeline fusion: collapse transformer chains into one operator.

Port of ``keystone_tpu/workflow/fusion.py``. :class:`NodeFusionRule`
rewrites maximal chains of array-in/array-out transformers
(``BatchTransformer`` subclasses implementing ``apply_arrays``) into a
single :class:`FusedTransformerOperator`, so a k-node featurization chain
is one graph node: one executor step, one memo entry, one pad-row
re-zeroing. The executor memoises every node's output until the pull
returns, so each interior member's output that the unfused plan kept
alive is now freed as soon as the next member has consumed it.

Fusion boundaries — nodes that always stay unfused:

- ``CacherOperator`` nodes (not a ``BatchTransformer``): a cache point
  must stay a real node so its output is memoized.
- Estimator fits and ``DelegatingOperator`` applications.
- Saveable-prefix cut points: any node in the optimizer's prefix map is
  about to have its result written to the state table and keeps its own
  identity.
- Transformers that override ``apply``/``apply_batch`` with bespoke
  behavior, or that set ``fusable = False``.

Ordering: fusion runs after node-level optimization, so structural
decisions upstream see real node boundaries. ``Pipeline.fit`` applies the
same rewrite to the transformer-only fitted graph, so serving
(``FittedPipeline.compiled_apply`` + ``utils/aot.warm_buckets``) warms
the *fused* chain at every bucket.

What the card does differently: the JAX chain is one ``jax.jit`` — one
XLA dispatch per chain. Here the members run eagerly, in one call, each
launching its own kernels; capturing a fused chain in a CUDA graph (or
``torch.compile``) is the card's counterpart of the single dispatch and
is later perf work. Because nothing is traced, the JAX chain's eager
fallback for untraceable members has no counterpart: an exception from a
member propagates and the operator stays fused.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, List, Optional, Sequence, Tuple

from ..envknobs import env_disabled
from ..obs import names as _names
from ..utils.tree import tree_leaves
from .graph import Graph, NodeId, SinkId
from .operators import TransformerOperator
from .pipeline import BatchTransformer
from .rules import PrefixMap, Rule


# ------------------------------------------------------------------ enablement

# Tri-state: None → env default (on unless KEYSTONE_FUSION=off/0). Tests
# flip it with set_fusion_enabled / fusion_disabled to build unfused
# reference pipelines for parity checks.
_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def fusion_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return not env_disabled("KEYSTONE_FUSION")


def set_fusion_enabled(value: Optional[bool]) -> None:
    """Force fusion on/off process-wide; ``None`` restores the env default."""
    global _enabled
    with _enabled_lock:
        _enabled = value


@contextmanager
def fusion_disabled():
    """Scoped off-switch (parity checks build the unfused reference here)."""
    global _enabled
    with _enabled_lock:
        prev = _enabled
        _enabled = False
    try:
        yield
    finally:
        with _enabled_lock:
            _enabled = prev


# ------------------------------------------------------------------- fusability


def _overrides(op, method: str) -> bool:
    return getattr(type(op), method, None) is not getattr(BatchTransformer, method)


def is_fusable(op) -> bool:
    """True when ``op``'s whole batch semantics are its ``apply_arrays``:
    a ``BatchTransformer`` that (a) implements ``apply_arrays``, (b) does
    NOT override the generic ``apply`` / ``apply_batch`` wrappers (a
    bespoke override does something the composed chain would silently
    skip), and (c) has not opted out via ``fusable = False``."""
    if not isinstance(op, BatchTransformer):
        return False
    if not getattr(op, "fusable", True):
        return False
    if not _overrides(op, "apply_arrays"):
        return False
    if _overrides(op, "apply") or _overrides(op, "apply_batch"):
        return False
    return True


# ------------------------------------------------------------------ fused op


class FusedTransformerOperator(BatchTransformer):
    """One operator standing in for a chain of array transformers.

    ``apply_arrays`` composes the members' ``apply_arrays`` eagerly in one
    call; each intermediate is dropped as soon as the next member has
    consumed it (none is memoised). The inherited
    :meth:`BatchTransformer.apply_batch` applies the framework conventions
    once for the whole chain (pad rows re-zeroed at the end — valid
    because ``apply_arrays`` is row-independent by contract, so once at
    the end equals once per member).

    ``keystone_fusion_compiles_total`` counts the first application of a
    chain at each new input (shape, dtype) — the rule by which the JAX
    package counts a new trace. Chains over the same member instances
    share one record of the shapes seen, through a bounded module cache:
    every optimizer run of an unfitted pipeline builds a fresh fused
    operator over the same members. An exception from a member
    propagates (the caller's reliability layer's business); the operator
    stays fused.
    """

    _is_fused = True

    def __init__(self, members: Sequence[TransformerOperator]):
        flat: List[TransformerOperator] = []
        for m in members:
            # Re-fusing a fused node flattens instead of nesting.
            if isinstance(m, FusedTransformerOperator):
                flat.extend(m.members)
            else:
                flat.append(m)
        if len(flat) < 2:
            raise ValueError("FusedTransformerOperator needs >= 2 members")
        self.members = tuple(flat)

    @property
    def label(self) -> str:
        return "Fused[" + "+".join(self.member_labels) + "]"

    @property
    def member_labels(self) -> Tuple[str, ...]:
        return tuple(str(getattr(m, "label", type(m).__name__)) for m in self.members)

    def apply_arrays(self, data):
        _note_chain_input(self.members, data)
        for m in self.members:
            data = m.apply_arrays(data)
        return data


# Input signatures seen per member-instance tuple, shared by every
# FusedTransformerOperator built over those instances. Keys are member
# ids; the value keeps strong refs to the members so an id cannot be
# recycled while its entry lives. Bounded LRU: each entry pins its
# members (fitted weights), so retired chains age out.
_CHAIN_SEEN: "OrderedDict[Tuple[int, ...], Tuple[tuple, set]]" = OrderedDict()
_CHAIN_SEEN_MAX = 32
_chain_lock = threading.Lock()


def _signature(data: Any) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in tree_leaves(data))


def _note_chain_input(members: tuple, data: Any) -> None:
    """Count the chain's first application at this input signature."""
    key = tuple(id(m) for m in members)
    sig = _signature(data)
    with _chain_lock:
        entry = _CHAIN_SEEN.get(key)
        if entry is None:
            entry = _CHAIN_SEEN[key] = (members, set())
            while len(_CHAIN_SEEN) > _CHAIN_SEEN_MAX:
                _CHAIN_SEEN.popitem(last=False)
        _CHAIN_SEEN.move_to_end(key)
        if sig in entry[1]:
            return
        entry[1].add(sig)
    _names.metric(_names.FUSION_COMPILES).inc()


# --------------------------------------------------------------------- the rule


class NodeFusionRule(Rule):
    """Rewrite maximal fusable chains into single fused nodes.

    A chain ``v1 → v2 → … → vk`` (k ≥ 2) qualifies when every member is
    fusable (:func:`is_fusable`), unary, outside the prefix map, and each
    interior member's ONLY consumer is its successor (a second consumer —
    node or sink — needs the intermediate value, so the chain is cut
    there). The final member may fan out freely: its consumers are
    repointed at the fused node.
    """

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        if not fusion_enabled():
            return graph, prefixes
        chains = _find_chains(graph, prefixes)
        if not chains:
            return graph, prefixes
        members_total = 0
        for chain in chains:
            graph = _fuse_chain(graph, chain)
            members_total += len(chain)
        _names.metric(_names.FUSION_CHAINS).inc(len(chains))
        _names.metric(_names.FUSION_FUSED_NODES).inc(members_total)
        _names.metric(_names.FUSION_DISPATCHES_SAVED).inc(members_total - len(chains))
        return graph, prefixes


def _find_chains(graph: Graph, prefixes: PrefixMap) -> List[List[NodeId]]:
    dependents = graph.dependents()

    def fusable(node: NodeId) -> bool:
        return (
            node not in prefixes  # saveable-prefix cut point
            and len(graph.get_dependencies(node)) == 1
            and is_fusable(graph.get_operator(node))
        )

    def sole_successor(node: NodeId) -> Optional[NodeId]:
        deps = dependents.get(node, [])
        if len(deps) != 1 or isinstance(deps[0], SinkId):
            return None
        (succ,) = deps
        if fusable(succ) and graph.get_dependencies(succ) == (node,):
            return succ
        return None

    chains: List[List[NodeId]] = []
    consumed = set()
    for node in sorted(graph.nodes):
        if node in consumed or not fusable(node):
            continue
        # Only start at a chain head: a fusable predecessor would have
        # already absorbed this node.
        (dep,) = graph.get_dependencies(node)
        if (
            isinstance(dep, NodeId)
            and dep not in consumed
            and fusable(dep)
            and sole_successor(dep) == node
        ):
            continue
        chain = [node]
        nxt = sole_successor(node)
        while nxt is not None:
            chain.append(nxt)
            nxt = sole_successor(chain[-1])
        if len(chain) >= 2:
            chains.append(chain)
            consumed.update(chain)
    return chains


def _fuse_chain(graph: Graph, chain: List[NodeId]) -> Graph:
    ops = [graph.get_operator(n) for n in chain]
    deps0 = graph.get_dependencies(chain[0])
    graph, fused_node = graph.add_node(FusedTransformerOperator(ops), deps0)
    graph = graph.replace_dependency(chain[-1], fused_node)
    for node in reversed(chain):
        graph = graph.remove_node(node)
    return graph


def fuse_graph(graph: Graph, prefixes: Optional[PrefixMap] = None) -> Graph:
    """Apply :class:`NodeFusionRule` directly to a graph (``Pipeline.fit``
    fuses the transformer-only fitted graph this way; the serving
    registry re-fuses artifacts saved unfused)."""
    out, _ = NodeFusionRule().apply(graph, dict(prefixes or {}))
    return out


__all__ = [
    "FusedTransformerOperator",
    "NodeFusionRule",
    "fuse_graph",
    "fusion_disabled",
    "fusion_enabled",
    "is_fusable",
    "set_fusion_enabled",
]
