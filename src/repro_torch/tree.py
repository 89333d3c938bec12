"""Minimal pytree helpers over dict, tuple (incl. NamedTuple), list and tensor.

Mirrors the subset of ``jax.tree`` the port needs.  Dict keys are visited in
sorted order, as JAX does, so ``tree_leaves`` of a port tree lists leaves in
the order JAX lists the same key paths.  ``None`` is an empty subtree, as in
JAX; every other non-container object is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` inverts it."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _walk(node: Any, leaves: List[Any]) -> Any:
    # a module-level recursion: a nested function that calls itself sits in
    # a reference cycle with its closure, which would keep ``leaves`` (and
    # so every tensor of the tree) alive until the cyclic collector runs
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (tuple, list)):
        return (type(node), None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return ("leaf",)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def _build(d: Any, it) -> Any:
    kind = d[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    children = [_build(c, it) for c in d[2]]
    if kind == "dict":
        return dict(zip(d[1], children))
    if issubclass(kind, tuple) and hasattr(kind, "_fields"):
        return kind(*children)
    return kind(children)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise; ``rest`` trees must share ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for other_leaves, other_def in others:
        if other_def != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [
        fn(*args) for args in zip(leaves, *(o[0] for o in others))])
