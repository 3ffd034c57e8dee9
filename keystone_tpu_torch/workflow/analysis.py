"""Graph analysis: ancestry, reachability, deterministic linearization.

Port of ``keystone_tpu/workflow/analysis.py`` (pure Python, copied),
a re-design of the reference's graph analyses
(reference: workflow/AnalysisUtils.scala:3-122).

Linearization is ITERATIVE (an explicit DFS stack) and cycle-checking:
the graph surgery API (``set_dependencies`` / ``replace_dependency``)
can produce a cyclic "DAG", and before this module detected it the
failure mode was a recursion overflow deep inside an ancestry walk —
or, worse, a silently wrong topological order feeding the executor.
A cycle now raises :class:`GraphCycleError` carrying the exact cycle
path (the JAX package's plan-time verifier, not yet ported, surfaces it
as a ``KV401`` diagnostic before any data touches a device). Deep linear
chains (thousands of nodes) linearize without hitting the interpreter
recursion limit for the same reason.
"""

from __future__ import annotations

from typing import List, Optional, Set

from .graph import Graph, GraphId, NodeId, SinkId


class GraphCycleError(ValueError):
    """A dependency walk found a cycle. ``cycle`` is the closed path
    (first vertex repeated last) in dependency order."""

    def __init__(self, cycle: List[GraphId]):
        self.cycle = list(cycle)
        path = " -> ".join(repr(v) for v in self.cycle)
        super().__init__(
            f"pipeline graph contains a dependency cycle: {path} "
            "(a node transitively depends on its own output; check "
            "set_dependencies/replace_dependency surgery)"
        )


def get_parents(graph: Graph, vid: GraphId) -> List[GraphId]:
    """Direct dependencies of a vertex, in order."""
    if isinstance(vid, SinkId):
        return [graph.get_sink_dependency(vid)]
    if isinstance(vid, NodeId):
        return list(graph.get_dependencies(vid))
    return []


def get_children(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """All vertices that directly consume ``vid``."""
    children: Set[GraphId] = set()
    for node, deps in graph.dependencies.items():
        if vid in deps:
            children.add(node)
    for sink, dep in graph.sink_dependencies.items():
        if dep == vid:
            children.add(sink)
    return children


def get_ancestors(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """Transitive closure of parents (excluding ``vid`` itself)."""
    seen: Set[GraphId] = set()
    stack = get_parents(graph, vid)
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        stack.extend(get_parents(graph, v))
    return seen


def get_descendants(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """Transitive closure of children (excluding ``vid`` itself)."""
    seen: Set[GraphId] = set()
    stack = list(get_children(graph, vid))
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        stack.extend(get_children(graph, v))
    return seen


def find_cycle(graph: Graph) -> Optional[List[GraphId]]:
    """The first dependency cycle found, as a closed path (first vertex
    repeated last), or ``None`` for a genuine DAG. Deterministic: roots
    and dependencies are visited in sorted/declared order."""
    seen: Set[GraphId] = set()
    roots = sorted(graph.sink_dependencies) + sorted(graph.operators)
    for root in roots:
        if root in seen:
            continue
        cycle = _dfs(graph, root, seen, collect=None)
        if cycle is not None:
            return cycle
    return None


def _dfs(
    graph: Graph,
    root: GraphId,
    seen: Set[GraphId],
    collect: Optional[List[GraphId]],
) -> Optional[List[GraphId]]:
    """Iterative post-order DFS from ``root``.

    Appends finished vertices to ``collect`` (when given) in
    topological order; returns a closed cycle path if one is reachable,
    else ``None``. ``seen`` persists across calls so multi-root walks
    share work.
    """
    # Stack of (vertex, parent-iterator); on_stack is the grey set.
    on_stack: Set[GraphId] = set()
    path: List[GraphId] = []
    stack = [(root, iter(get_parents(graph, root)))]
    if root in seen:
        return None
    seen.add(root)
    on_stack.add(root)
    path.append(root)
    while stack:
        vertex, parents = stack[-1]
        advanced = False
        for parent in parents:
            if parent in on_stack:
                # Back edge: close the cycle from parent's position.
                start = path.index(parent)
                return path[start:] + [parent]
            if parent in seen:
                continue
            seen.add(parent)
            on_stack.add(parent)
            path.append(parent)
            stack.append((parent, iter(get_parents(graph, parent))))
            advanced = True
            break
        if not advanced:
            stack.pop()
            on_stack.discard(vertex)
            path.pop()
            if collect is not None:
                collect.append(vertex)
    return None


def linearize(graph: Graph, vid: GraphId) -> List[GraphId]:
    """Deterministic topological order of ``vid``'s ancestors plus ``vid``.

    Depth-first post-order with ordered dependency traversal, so equal
    graphs always linearize identically (reference: AnalysisUtils.scala
    topological linearization). Raises :class:`GraphCycleError` if the
    walk closes a cycle.
    """
    order: List[GraphId] = []
    cycle = _dfs(graph, vid, set(), collect=order)
    if cycle is not None:
        raise GraphCycleError(cycle)
    return order


def linearize_whole(graph: Graph) -> List[GraphId]:
    """Topological order over the entire graph (all sinks, sorted).
    Raises :class:`GraphCycleError` on a cyclic graph."""
    order: List[GraphId] = []
    seen: Set[GraphId] = set()
    for root in sorted(graph.sink_dependencies) + sorted(graph.operators):
        cycle = _dfs(graph, root, seen, collect=order)
        if cycle is not None:
            raise GraphCycleError(cycle)
    return order
