"""Sharding plan: param and optimizer partition specs by tree path (port
of ``repro.launch.sharding``).

Megatron-style TP on the flattened head·d_head / d_ff / padded-vocab dims
over 'model'; FSDP (ZeRO-3) over 'data' (+'pod' for ≥50 GB trees); MoE
experts over 'model' (EP).  Rules match on path substrings and apply to
the *trailing* dims, so layer-stacked ([L, ...]) and superblock-stacked
([n_apps, E, ...]) params resolve automatically.

The reference places a tree with ``jax.device_put(tree, shardings)`` and
lets GSPMD run the step; the port places it with
``core.placement.place_tree``, which turns each leaf into a ``Sharded``
value (its pieces on their shards' devices).  The reference's cache and
batch specs (``cache_batch_axes``, ``cache_shardings``,
``batch_shardings``) and its ``strategy="fsdp_pure"`` serve only its XLA
dry run, which the port does not have (ROADMAP, Modules with no
counterpart); the train step splits a batch with
``core.placement.split_batch``.
"""
from __future__ import annotations

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


def _with_path(fn: Callable, tree: Any, path=()) -> Any:
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params: Any, mesh: Mesh, fsdp: tuple[str, ...] | None) -> Any:
    """A tree of NamedShardings matching a params tree (tensors, ``meta``
    tensors or Sharded: only shapes are read): Megatron TP over 'model' +
    FSDP over ``fsdp`` (the reference's default ``strategy="tp"``)."""
    f = tuple(fsdp) if fsdp else None
    return _with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(_path_str(path), len(leaf.shape), f)),
        params)


def opt_shardings(opt: AdamWState, params_sh: Any, mesh: Mesh) -> AdamWState:
    """AdamW moments shard exactly like their params; the step is
    replicated."""
    return AdamWState(step=NamedSharding(mesh, P()), mu=params_sh, nu=params_sh)


def tree_bytes(tree: Any) -> int:
    """Bytes of the logical values of a tree (tensors, ``meta`` tensors or
    Sharded), each logical element counted once."""
    total = 0

    def add(x):
        nonlocal total
        total += math.prod(x.shape) * x.dtype.itemsize

    map_tree(add, tree)
    return total


__all__ = ["opt_shardings", "param_pspec", "param_shardings", "tree_bytes"]
