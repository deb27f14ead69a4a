"""Nested dicts (and tuples) of tensors: the port's parameter and state
trees, walked in the JAX package's leaf order (dict keys sorted)."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "leaves_with_path", "map_tree", "map_trees"]

SEP = "/"


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def map_trees(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure (``tree``'s)."""
    if isinstance(tree, dict):
        return {k: map_trees(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf: dict keys sorted, tuple and list items
    by index, a path's parts joined by "/" as the JAX package's checkpoint
    names them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_path(v, f"{prefix}{SEP}{k}" if prefix else k)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]
