"""Nested parameter trees: dicts, lists and tuples of tensors.

The port keeps the JAX package's pytrees as plain containers of leaf
tensors. Leaves are visited in ``jax.tree.leaves`` order (dict keys
sorted), so sums over leaves group as the reference's do. Anything that is
not a dict, list or tuple is a leaf (a ``NamedTuple`` is a tuple).
"""

from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, list):
        return list(children)
    if hasattr(tree, "_fields"):            # NamedTuple
        return type(tree)(*children)
    return tuple(children)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_leaves(k)]


def tree_unflatten(tree, leaves) -> Any:
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        return _rebuild(t, [build(k) for k in kids])

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees shaped like it."""
    columns = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*columns)])
