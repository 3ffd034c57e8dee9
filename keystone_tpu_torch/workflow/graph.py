"""Untyped dataflow-graph IR for the pipeline layer.

Port of ``keystone_tpu/workflow/graph.py`` (pure Python, copied),
itself a re-design of the reference's immutable DAG
(reference: workflow/Graph.scala:32-455, workflow/GraphId.scala:1-31).
A ``Graph`` is a persistent (copy-on-write) structure: every surgery
operation returns a new ``Graph``, so optimizer rules can rewrite plans
without aliasing hazards.

Vocabulary (mirrors the reference's semantics, not its code):

- ``SourceId``  — an unbound input of the graph (pipeline input).
- ``NodeId``    — an operator application; has an ordered dependency list.
- ``SinkId``    — a named output; depends on exactly one node or source.

Unlike the reference (JVM objects over Spark RDDs), the operators this
graph carries execute against tensors on a CUDA device (or the CPU when
asked); the graph itself is pure host-side Python.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover
    from .operators import Operator


@dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self) -> str:
        return f"n{self.id}"


@dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self) -> str:
        return f"src{self.id}"


@dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self) -> str:
        return f"sink{self.id}"


#: Anything a node or sink may depend on.
NodeOrSourceId = Union[NodeId, SourceId]
#: Any vertex in the graph.
GraphId = Union[NodeId, SourceId, SinkId]


class Graph:
    """Immutable dataflow DAG.

    Parameters
    ----------
    sources:
        Unbound inputs.
    sink_dependencies:
        Mapping sink -> the node/source whose value it exposes.
    operators:
        Mapping node -> operator.
    dependencies:
        Mapping node -> ordered list of nodes/sources it consumes.
    """

    __slots__ = ("sources", "sink_dependencies", "operators", "dependencies", "_max_id")

    def __init__(
        self,
        sources: Iterable[SourceId] = (),
        sink_dependencies: Optional[Mapping[SinkId, NodeOrSourceId]] = None,
        operators: Optional[Mapping[NodeId, "Operator"]] = None,
        dependencies: Optional[Mapping[NodeId, Sequence[NodeOrSourceId]]] = None,
    ):
        self.sources = frozenset(sources)
        self.sink_dependencies = dict(sink_dependencies or {})
        self.operators = dict(operators or {})
        self.dependencies = {k: tuple(v) for k, v in (dependencies or {}).items()}
        ids = [s.id for s in self.sources]
        ids += [s.id for s in self.sink_dependencies]
        ids += [n.id for n in self.operators]
        self._max_id = max(ids) if ids else -1

    # ------------------------------------------------------------------ views
    @property
    def nodes(self) -> frozenset:
        return frozenset(self.operators)

    @property
    def sinks(self) -> frozenset:
        return frozenset(self.sink_dependencies)

    def get_operator(self, node: NodeId) -> "Operator":
        return self.operators[node]

    def get_dependencies(self, node: NodeId) -> Tuple[NodeOrSourceId, ...]:
        return self.dependencies[node]

    def get_sink_dependency(self, sink: SinkId) -> NodeOrSourceId:
        return self.sink_dependencies[sink]

    def _next_ids(self) -> Iterable[int]:
        return itertools.count(self._max_id + 1)

    def dependents(self) -> Dict[NodeId, List[GraphId]]:
        """node → list of consumers (nodes AND sinks — a sink read counts).

        The shared reverse-edge view used by the auto-cache planner
        (reuse counting) and the fusion pass (chain cutting): both must
        agree on what 'consumer' means or their rewrites would disagree
        about node boundaries.
        """
        out: Dict[NodeId, List[GraphId]] = {n: [] for n in self.operators}
        for node, deps in self.dependencies.items():
            for dep in deps:
                if isinstance(dep, NodeId):
                    out[dep].append(node)
        for sink, dep in self.sink_dependencies.items():
            if isinstance(dep, NodeId):
                out[dep].append(sink)
        return out

    # --------------------------------------------------------------- surgery
    def add_node(self, op: "Operator", deps: Sequence[NodeOrSourceId]) -> Tuple["Graph", NodeId]:
        node = NodeId(self._max_id + 1)
        operators = dict(self.operators)
        operators[node] = op
        dependencies = dict(self.dependencies)
        dependencies[node] = tuple(deps)
        return Graph(self.sources, self.sink_dependencies, operators, dependencies), node

    def add_source(self) -> Tuple["Graph", SourceId]:
        source = SourceId(self._max_id + 1)
        return (
            Graph(self.sources | {source}, self.sink_dependencies, self.operators, self.dependencies),
            source,
        )

    def add_sink(self, dep: NodeOrSourceId) -> Tuple["Graph", SinkId]:
        sink = SinkId(self._max_id + 1)
        sink_deps = dict(self.sink_dependencies)
        sink_deps[sink] = dep
        return Graph(self.sources, sink_deps, self.operators, self.dependencies), sink

    def set_operator(self, node: NodeId, op: "Operator") -> "Graph":
        if node not in self.operators:
            raise KeyError(f"{node} not in graph")
        operators = dict(self.operators)
        operators[node] = op
        return Graph(self.sources, self.sink_dependencies, operators, self.dependencies)

    def set_dependencies(self, node: NodeId, deps: Sequence[NodeOrSourceId]) -> "Graph":
        if node not in self.operators:
            raise KeyError(f"{node} not in graph")
        dependencies = dict(self.dependencies)
        dependencies[node] = tuple(deps)
        return Graph(self.sources, self.sink_dependencies, self.operators, dependencies)

    def set_sink_dependency(self, sink: SinkId, dep: NodeOrSourceId) -> "Graph":
        sink_deps = dict(self.sink_dependencies)
        sink_deps[sink] = dep
        return Graph(self.sources, sink_deps, self.operators, self.dependencies)

    def remove_sink(self, sink: SinkId) -> "Graph":
        sink_deps = dict(self.sink_dependencies)
        del sink_deps[sink]
        return Graph(self.sources, sink_deps, self.operators, self.dependencies)

    def remove_source(self, source: SourceId) -> "Graph":
        self._check_unreferenced(source)
        return Graph(self.sources - {source}, self.sink_dependencies, self.operators, self.dependencies)

    def remove_node(self, node: NodeId) -> "Graph":
        self._check_unreferenced(node)
        operators = dict(self.operators)
        del operators[node]
        dependencies = dict(self.dependencies)
        del dependencies[node]
        return Graph(self.sources, self.sink_dependencies, operators, dependencies)

    def _check_unreferenced(self, vid: NodeOrSourceId) -> None:
        for deps in self.dependencies.values():
            if vid in deps:
                raise ValueError(f"cannot remove {vid}: still referenced by a node")
        for dep in self.sink_dependencies.values():
            if dep == vid:
                raise ValueError(f"cannot remove {vid}: still referenced by a sink")

    def replace_dependency(self, old: NodeOrSourceId, new: NodeOrSourceId) -> "Graph":
        """Redirect every reference to ``old`` to ``new``."""
        dependencies = {
            node: tuple(new if d == old else d for d in deps)
            for node, deps in self.dependencies.items()
        }
        sink_deps = {
            sink: (new if d == old else d) for sink, d in self.sink_dependencies.items()
        }
        return Graph(self.sources, sink_deps, self.operators, dependencies)

    # ------------------------------------------------------------ composition
    def add_graph(self, other: "Graph") -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Disjoint union; ``other``'s ids are remapped past this graph's ids.

        Returns the union plus maps from ``other``'s source/sink ids to their
        new ids (reference: workflow/Graph.scala:290 ``addGraph``).
        """
        counter = itertools.count(self._max_id + 1)
        node_map: Dict[NodeId, NodeId] = {n: NodeId(next(counter)) for n in sorted(other.operators)}
        source_map: Dict[SourceId, SourceId] = {s: SourceId(next(counter)) for s in sorted(other.sources)}
        sink_map: Dict[SinkId, SinkId] = {s: SinkId(next(counter)) for s in sorted(other.sink_dependencies)}

        def remap(x: NodeOrSourceId) -> NodeOrSourceId:
            if isinstance(x, NodeId):
                return node_map[x]
            return source_map[x]

        operators = dict(self.operators)
        dependencies = dict(self.dependencies)
        for node, op in other.operators.items():
            operators[node_map[node]] = op
            dependencies[node_map[node]] = tuple(remap(d) for d in other.dependencies[node])
        sink_deps = dict(self.sink_dependencies)
        for sink, dep in other.sink_dependencies.items():
            sink_deps[sink_map[sink]] = remap(dep)
        sources = self.sources | frozenset(source_map.values())
        return Graph(sources, sink_deps, operators, dependencies), source_map, sink_map

    def connect_graph(
        self, other: "Graph", splice: Mapping[SourceId, SinkId]
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Union with ``other``, binding its sources to this graph's sinks.

        For each ``(other_source -> this_sink)`` pair, the spliced source is
        replaced by whatever the sink exposes, and both the source and the
        sink disappear (reference: workflow/Graph.scala:340 ``connectGraph``,
        the substrate of ``Chainable.andThen``).
        """
        combined, source_map, sink_map = self.add_graph(other)
        for other_source, this_sink in splice.items():
            new_source = source_map[other_source]
            target = combined.get_sink_dependency(this_sink)
            combined = combined.replace_dependency(new_source, target)
            combined = combined.remove_source(new_source)
            combined = combined.remove_sink(this_sink)
            del source_map[other_source]
        return combined, source_map, sink_map

    def replace_nodes(
        self,
        nodes_to_remove: Iterable[NodeId],
        replacement: "Graph",
        replacement_source_splice: Mapping[SourceId, NodeOrSourceId],
        replacement_sink_splice: Mapping[NodeId, SinkId],
    ) -> "Graph":
        """Swap a set of nodes for a replacement subgraph.

        ``replacement_source_splice`` binds the replacement's sources onto
        surviving vertices of this graph; ``replacement_sink_splice`` says
        which replacement sink stands in for each removed node
        (reference: workflow/Graph.scala:379 ``replaceNodes``).
        """
        removed = set(nodes_to_remove)
        combined, source_map, sink_map = self.add_graph(replacement)
        # Bind replacement sources to surviving graph vertices.
        for rsource, target in replacement_source_splice.items():
            new_source = source_map[rsource]
            combined = combined.replace_dependency(new_source, target)
            combined = combined.remove_source(new_source)
        # Redirect consumers of removed nodes to replacement sinks' deps.
        for removed_node, rsink in replacement_sink_splice.items():
            new_sink = sink_map[rsink]
            target = combined.get_sink_dependency(new_sink)
            combined = combined.replace_dependency(removed_node, target)
            combined = combined.remove_sink(new_sink)
        # Drop remaining replacement sinks.
        for rsink, new_sink in sink_map.items():
            if new_sink in combined.sink_dependencies:
                combined = combined.remove_sink(new_sink)
        # Remove the dead nodes (in dependency-safe order: repeatedly strip
        # nodes that nothing references).
        pending = set(removed)
        while pending:
            progressed = False
            for node in list(pending):
                try:
                    combined = combined.remove_node(node)
                except ValueError:
                    continue
                pending.discard(node)
                progressed = True
            if not progressed:
                raise ValueError(f"could not remove nodes {pending}: external references remain")
        return combined

    # ---------------------------------------------------------------- export
    def to_dot(self, name: str = "pipeline") -> str:
        """Graphviz DOT export (reference: workflow/Graph.scala:436-455)."""
        lines = [f"digraph {name} {{", "  rankdir=LR;"]
        for source in sorted(self.sources):
            lines.append(f'  "{source!r}" [shape=oval, label="{source!r}"];')
        for node in sorted(self.operators):
            label = getattr(self.operators[node], "label", type(self.operators[node]).__name__)
            lines.append(f'  "{node!r}" [shape=box, label="{label}"];')
        for sink in sorted(self.sink_dependencies):
            lines.append(f'  "{sink!r}" [shape=diamond, label="{sink!r}"];')
        for node, deps in sorted(self.dependencies.items()):
            for i, dep in enumerate(deps):
                lines.append(f'  "{dep!r}" -> "{node!r}" [label="{i}"];')
        for sink, dep in sorted(self.sink_dependencies.items()):
            lines.append(f'  "{dep!r}" -> "{sink!r}";')
        lines.append("}")
        return "\n".join(lines)

    # ------------------------------------------------------------- equality
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Graph):
            return NotImplemented
        return (
            self.sources == other.sources
            and self.sink_dependencies == other.sink_dependencies
            and self.operators == other.operators
            and self.dependencies == other.dependencies
        )

    def __hash__(self):  # graphs are not hashable (operators may not be)
        raise TypeError("Graph is not hashable")

    def __repr__(self) -> str:
        return (
            f"Graph(sources={sorted(self.sources)}, nodes={sorted(self.operators)}, "
            f"sinks={sorted(self.sink_dependencies)})"
        )
