"""Nested dicts of tensors as pytrees: the leaf order of ``jax.tree_util``
(dict keys sorted), so sums over leaves and checkpoint names follow the
reference's order."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of nested dicts / tuples, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``,
    keeping the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
