"""Nested containers of tensors ("trees"), walked in the JAX package's order.

A tree is a dict, a tuple (a NamedTuple included), a list, None or a leaf.
``leaves`` gives the leaves in ``jax.tree.leaves``' order: a dict's keys
sorted, a tuple's items and a NamedTuple's fields in order, None holding no
leaf.  The optimizer sums the gradient norm in this order, and a
checkpoint written by the JAX package (``payload.npz``, ``leaf_i``) is read
back by it.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["is_leaf", "leaves", "leaves_with_paths", "tree_map", "unflatten"]


def is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, tuple, list)) and x is not None


def _children(tree) -> list:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree.leaves``' order; a path joins keys,
    fields and indices with "/"."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(leaves_with_paths(child, f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the same-shaped ``rest``; the
    containers are rebuilt (a NamedTuple as its own type)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten(like, new_leaves):
    """A tree shaped as ``like`` holding ``new_leaves``, given in
    ``leaves(like)``'s order."""
    it = iter(new_leaves)

    def build(tree):
        if tree is None:
            return None
        if is_leaf(tree):
            return next(it)
        if isinstance(tree, dict):
            built = {k: build(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        items = [build(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
