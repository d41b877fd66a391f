"""Sharding plan: param, optimizer, cache and batch partition specs by tree
path (port of ``repro.launch.sharding``).

Megatron-style TP on the flattened head·d_head / d_ff / padded-vocab dims
over 'model'; FSDP (ZeRO-3) over 'data' (+'pod' for ≥50 GB trees); MoE
experts over 'model' (EP); decode KV caches sharded over batch×sequence
(the distributed-FIER axes).  Rules match on path substrings and apply to
the *trailing* dims, so layer-stacked ([L, ...]) and superblock-stacked
([n_apps, E, ...]) params resolve automatically.

The reference places a tree with ``jax.device_put(tree, shardings)`` and
lets GSPMD run the step; the port places it with
``core.placement.place_tree`` (or ``place_new``, which makes each piece on
its device), which turns each leaf into a ``Sharded`` value (its pieces on
their shards' devices).  A tree path is its keys joined by '/'; a cache's
side-car (``QuantizedKeys``, ``PageMeta``) adds its field names, as the
reference's pytree paths do.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

from repro_torch.core.placement import NamedSharding, P, map_tree
from repro_torch.optim.adamw import AdamWState

from .mesh import Mesh


# rule: (path regex, trailing-dims spec builder given (fsdp, model))
_RULES: list[tuple[str, Any]] = [
    (r"moe/w1$|moe/w3$", lambda f, m: (m, f, None)),   # [E, d, ff] → EP
    (r"moe/w2$", lambda f, m: (m, None, f)),           # [E, ff, d]
    (r"moe/router$", lambda f, m: (None, None)),
    (r"embed$", lambda f, m: (m, f)),                  # [Vp, d]
    (r"lm_head$", lambda f, m: (f, m)),                # [d, Vp]
    (r"pos_dec$", lambda f, m: (None, f)),
    (r"wq$|wk$|wv$", lambda f, m: (f, m)),             # [d, H·Dh]
    (r"wo$", lambda f, m: (m, f)),                     # [H·Dh, d]
    (r"w1$|w3$", lambda f, m: (f, m)),                 # [d, ff]
    (r"w2$", lambda f, m: (m, f)),                     # [ff, d]
    (r"bq$|bk$|bv$", lambda f, m: (m,)),
    (r"in_proj$", lambda f, m: (f, m)),                # [d, 2di+2N+H]
    (r"out_proj$", lambda f, m: (m, f)),               # [di, d]
    (r"conv_w$|conv_b$", lambda f, m: None),           # small, replicate
    (r"norm_w$|A_log$|D$|dt_bias$", lambda f, m: None),
]


def _path_str(path) -> str:
    """A tree path (a sequence of dict keys / indices) as the reference
    writes it: the keys joined by '/'."""
    return "/".join(str(k) for k in path)


def param_pspec(path_str: str, ndim: int, fsdp, model: str = "model") -> P:
    f = fsdp if fsdp else None
    for pat, builder in _RULES:
        if re.search(pat, path_str):
            tail = builder(f, model)
            if tail is None:
                return P()
            pad = ndim - len(tail)
            if pad < 0:  # param smaller than rule (e.g. un-stacked bias)
                tail = tail[-ndim:]
                pad = 0
            return P(*([None] * pad + list(tail)))
    return P()  # norms, scalars → replicated


def map_with_path(fn: Callable, tree: Any, *rest: Any, path=()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over nested dicts and side-car
    dataclasses (their ``FIELDS``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and hasattr(tree, "FIELDS"):
        return dataclasses.replace(tree, **{
            f: map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                             path=path + (f,))
            for f in tree.FIELDS})
    return fn(path, tree, *rest)


def param_shardings(params: Any, mesh: Mesh, fsdp: tuple[str, ...] | None,
                    strategy: str = "tp") -> Any:
    """A tree of NamedShardings matching a params tree (tensors, ``meta``
    tensors or Sharded: only shapes are read).

    strategy="tp": Megatron TP over 'model' + FSDP over ``fsdp`` (default).
    strategy="fsdp_pure": no tensor parallelism — every ≥2-D param shards
    its first dim that divides over ALL of ``fsdp`` (ZeRO-3); the batch
    then spans the whole mesh."""
    f = tuple(fsdp) if fsdp else None
    if strategy == "fsdp_pure":
        n = math.prod(mesh.shape[a] for a in f or ())

        def one_fsdp(path, leaf):
            if f and len(leaf.shape) >= 2:
                for dim, d in enumerate(leaf.shape):
                    if d % n == 0 and d >= n:
                        spec = [None] * len(leaf.shape)
                        spec[dim] = f
                        return NamedSharding(mesh, P(*spec))
            return NamedSharding(mesh, P())

        return map_with_path(one_fsdp, params)
    if strategy != "tp":
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(_path_str(path), len(leaf.shape), f)),
        params)


def opt_shardings(opt: AdamWState, params_sh: Any, mesh: Mesh) -> AdamWState:
    """AdamW moments shard exactly like their params; the step is
    replicated."""
    return AdamWState(step=NamedSharding(mesh, P()), mu=params_sh, nu=params_sh)


# ------------------------------------------------------------ cache / batch

def cache_batch_axes(init_cache: Callable, capacity: int | None = None) -> Any:
    """Every cache leaf's batch-axis index, found by diffing the shapes of
    ``init_cache(B, capacity, 0, device="meta")`` at B 2 and 3 (``meta``
    tensors: shapes only).  The probe capacity must pass the plan's
    capacity check (budget <= capacity, block divisibility): pass the
    cell's own when known; with None the probe grows a capacity until the
    check accepts it (the odd multipliers cover block sizes with an odd
    factor, 24, 40, 48, …)."""
    caps = ([capacity] if capacity is not None else
            [b * m for b in (64, 1024, 8192, 1 << 20) for m in (1, 3, 5, 7)])
    err = None
    for cap in caps:
        try:
            c2 = init_cache(2, cap, 0, device="meta")
            c3 = init_cache(3, cap, 0, device="meta")
            break
        except ValueError as e:
            err = e
    else:
        raise err

    def axis(_, a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diffs) != 1:
            raise ValueError(f"ambiguous batch axis: {tuple(a.shape)} vs {tuple(b.shape)}")
        return diffs[0]

    return map_with_path(axis, c2, c3)


_SLAB = re.compile(r"(^|/)(k|v|codes|scale|zero|kmax|kmin)$")


def cache_shardings(cache: Any, mesh: Mesh, batch: tuple[str, ...], seq: tuple[str, ...],
                    batch_axis_tree: Any) -> Any:
    """Decode-cache shardings: the batch dim over ``batch`` axes; for the KV
    slabs and their side-cars, the sequence dim (the batch dim + 1) over
    ``seq`` axes (distributed FIER).  Mamba / conv states and cross-attention
    caches shard on batch only."""
    b = tuple(batch) if batch else None
    s = tuple(seq) if seq else None

    def one(path, leaf, baxis):
        ps = _path_str(path)
        nd = len(leaf.shape)
        spec = [None] * nd
        spec[baxis] = b
        is_slab = _SLAB.search(ps) or "meta" in ps
        if is_slab and "cross" not in ps and nd > baxis + 1:
            spec[baxis + 1] = s
        return NamedSharding(mesh, P(*spec))

    return map_with_path(one, cache, batch_axis_tree)


def batch_shardings(batch: Any, mesh: Mesh, axes: tuple[str, ...]) -> Any:
    """Each batch leaf's leading dim over ``axes``."""
    b = tuple(axes) if axes else None
    return map_with_path(
        lambda _, leaf: NamedSharding(mesh, P(*([b] + [None] * (len(leaf.shape) - 1))
                                               if len(leaf.shape) else ())),
        batch)


def tree_bytes(tree: Any) -> int:
    """Bytes of the logical values of a tree (tensors, ``meta`` tensors or
    Sharded), each logical element counted once."""
    total = 0

    def add(x):
        nonlocal total
        total += math.prod(x.shape) * x.dtype.itemsize

    map_tree(add, tree)
    return total


__all__ = ["batch_shardings", "cache_batch_axes", "cache_shardings", "map_with_path",
           "opt_shardings", "param_pspec", "param_shardings", "tree_bytes"]
