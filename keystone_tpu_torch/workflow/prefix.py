"""Structural prefixes: cross-pipeline memoization keys.

Port of ``keystone_tpu/workflow/prefix.py`` (pure Python, copied).

A *prefix* is the operator tree feeding a node — a structural fingerprint
of "everything computed to produce this value". Two nodes in different
pipelines with equal prefixes computed the same thing, so the executor's
result for one can be spliced into the other
(reference: workflow/Prefix.scala:4-30, workflow/ExtractSaveablePrefixes.scala:9-22).

A prefix only exists when the node's ancestry contains no unbound sources
(a value depending on a free input is not a constant).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .graph import Graph, NodeOrSourceId, SourceId


@dataclass(frozen=True)
class Prefix:
    """Hashable operator-tree fingerprint."""

    tree: Tuple  # nested (operator, (child trees...))

    def __repr__(self) -> str:
        return f"Prefix({hash(self.tree):#x})"


def find_prefix(graph: Graph, node: NodeOrSourceId) -> Optional[Prefix]:
    """Build the prefix of ``node``, or None if it depends on a source.

    Operators participate by object identity (the default ``Operator``
    hash/eq) or by value when an operator defines structural equality.
    """
    tree = _tree(graph, node)
    if tree is None:
        return None
    return Prefix(tree)


def _tree(graph: Graph, vid: NodeOrSourceId):
    if isinstance(vid, SourceId):
        return None
    op = graph.get_operator(vid)
    children = []
    for dep in graph.get_dependencies(vid):
        sub = _tree(graph, dep)
        if sub is None:
            return None
        children.append(sub)
    return (op, tuple(children))
