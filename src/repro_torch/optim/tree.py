"""Nested dicts of tensors as pytrees: the leaf order of ``jax.tree_util``
(dict keys sorted), so sums over leaves and checkpoint names follow the
reference's order.  A mesh's ``core.placement.Sharded`` value is one leaf;
``map_leaves`` maps over its pieces, so the optimizer runs per piece and
its state shards like the params."""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.placement import Sharded


def leaves(tree: Any) -> list:
    """The leaves of nested dicts / tuples, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``,
    keeping the structure of ``tree``; over a Sharded leaf (whose
    counterparts in ``rest`` share its sharding), ``fn`` maps piece by
    piece."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.map_pieces(fn, *rest)
    return fn(tree, *rest)


def pieces(x: Any) -> list:
    """The stored pieces of a Sharded leaf, or ``[x]``: each logical element
    once."""
    return x.pieces if isinstance(x, Sharded) else [x]
