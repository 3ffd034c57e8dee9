"""A small tree-map over nested tuples, lists and dicts of tensors.

The JAX package walks dataset pytrees with ``jax.tree_util``; the port
keeps this minimal counterpart. Containers are tuples, lists and dicts
(leaves of a dict in sorted-key order, as ``jax.tree_util`` orders them);
everything else is a leaf. ``None`` is a leaf too.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_container(x: Any) -> bool:
    return isinstance(x, (tuple, list, dict))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_structure(tree: Any) -> Any:
    """A hashable description of ``tree``'s containers with its leaves
    left out: two trees with equal structures map leaf for leaf."""
    if isinstance(tree, dict):
        return ("dict", tuple((key, tree_structure(tree[key])) for key in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(tree_structure(sub) for sub in tree))
    return "*"


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise to ``tree`` (and to the matching leaves of
    ``rest``, which must have the same structure); containers keep their
    type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        for r in rest:
            if not _is_container(r) or len(r) != len(tree):
                raise ValueError("tree_map: trees differ in structure")
        out = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)
