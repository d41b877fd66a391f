"""Megatron tensor parallelism over a mesh's 'model' axis, single-controller:
the readers of TP pieces that the sharded train step
(``models/sharded_train.py``) and the placed serving steps
(``models/transformer.py``) share.

A placed param is a ``core.placement.Sharded`` leaf, placed by
``launch.sharding.param_shardings``: TP over 'model' on the dims
``param_pspec`` names (column-parallel wq/wk/wv/bq/bk/bv/w1/w3, row-parallel
wo/w2, the vocab of embed and lm_head, the experts of moe/*), FSDP over the
data axes on another dim.  Each (data shard, model shard) computes with its
own TP block, gathered over the FSDP axes only (:class:`Views`); the
row-parallel products meet in a psum (:func:`row_sum`), the vocab-split
embedding in another (:func:`vocab_parallel_embed`).

* :class:`Shards`: the (data shard, model shard) grid of a mesh.
* :func:`tp_keep`: the dims ``param_pspec`` splits over 'model'.
* :func:`check_placed`: whether a placed tree can take this layout; it
  raises naming the leaf and the reason where it cannot, rather than
  gathering the leaf whole.
* :func:`placed_mesh`, :func:`same_mesh`: the mesh a tree is placed on.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import distributed as dist
from repro_torch.core.placement import Sharded, as_sharded, axis_coords
from repro_torch.launch.sharding import map_with_path, param_pspec


class Shards:
    """The (data shard, model shard) grid of a mesh: the data shards run
    over ``b_axes`` (row-major), the model shards over 'model'.  With
    ``strict`` (training) every other mesh axis is refused; a serving step
    whose batch does not split (one request, or a batch of 1) sits at index
    0 of the axes it does not name."""

    def __init__(self, mesh, b_axes, strict: bool = True):
        self.mesh = mesh
        self.b_axes = tuple(a for a in b_axes if a in mesh.shape)
        other = set(mesh.axis_names) - set(self.b_axes) - {"model"}
        if other and strict:
            raise ValueError(f"mesh axes {sorted(other)} are neither batch axes nor 'model'")
        self.n_dp = math.prod(mesh.shape[a] for a in self.b_axes)
        self.n_tp = mesh.shape.get("model", 1)

    def coords(self, t: int, m: int = 0) -> dict[str, int]:
        c = axis_coords(self.mesh, self.b_axes, t)
        if "model" in self.mesh.shape:
            c["model"] = m
        return c

    def dev(self, t: int, m: int = 0) -> torch.device:
        return self.mesh.device_at(self.coords(t, m))


def tp_keep(path: str, ndim: int) -> dict[int, tuple[str, ...]]:
    """The dims TP splits over 'model' for a leaf at ``path`` (the rules of
    ``param_pspec`` without FSDP)."""
    return {d: ("model",) for d, a in enumerate(param_pspec(path, ndim, None)) if a == "model"}


class Views:
    """What each shard computes with, gathered once per (leaf, shard)
    within one call: per shard, not per device, so the collectives a step
    records do not depend on where the shards sit."""

    def __init__(self, shards: Shards):
        self.shards, self.memo = shards, {}

    def tp(self, x, path: str, t: int, m: int) -> torch.Tensor:
        dev = self.shards.dev(t, m)
        key = (id(x), t, m)
        if key not in self.memo:
            xs = as_sharded(x, self.shards.mesh)
            self.memo[key] = xs.view(self.shards.coords(t, m), tp_keep(path, xs.ndim), dev)
        return self.memo[key]

    def tree(self, tree: dict, prefix: str, t: int, m: int) -> dict:
        return {k: self.tree(v, f"{prefix}/{k}", t, m) if isinstance(v, dict)
                else self.tp(v, f"{prefix}/{k}", t, m) for k, v in tree.items()}


def row_sum(parts: list[torch.Tensor], name: str) -> torch.Tensor:
    """A row-parallel product's psum over the model shards (``name``: wo,
    w2 or moe), in f32, on the first shard's device."""
    return dist.psum([x.to(torch.float32) for x in parts])[0]


def vocab_parallel_embed(Es: list[torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-split embedding: each model shard looks up the tokens
    in its own rows (zeros elsewhere) and a psum adds them, exactly (one
    non-zero term).  f32, on the first model shard's device."""
    Vl = Es[0].shape[0]
    parts = []
    for m, E in enumerate(Es):
        local = tokens.to(E.device) - m * Vl
        ok = (local >= 0) & (local < Vl)
        parts.append(torch.where(ok[..., None], E[local.clamp(0, Vl - 1)], 0.0))
    return dist.psum(parts)[0]


# ------------------------------------------------------------ placed trees

def placed_mesh(tree: Any):
    """The mesh of the first ``Sharded`` leaf of ``tree`` (nested dicts), or
    None when no leaf is placed."""
    if isinstance(tree, Sharded):
        return tree.mesh
    if isinstance(tree, dict):
        for v in tree.values():
            mesh = placed_mesh(v)
            if mesh is not None:
                return mesh
    return None


def same_mesh(a, b) -> bool:
    """Whether two meshes name the same shards (axes, sizes and devices)."""
    return a is b or (a.axis_names == b.axis_names and a.shape == b.shape
                      and a.devices == b.devices)


def check_placed(params: dict, mesh) -> None:
    """Raise ``ValueError`` naming the leaf and the reason when a placed
    param tree cannot serve Megatron-parallel over ``mesh``: a leaf placed
    on another mesh, or a leaf split over 'model' on another dim than its
    TP dim (the step would have to gather it whole).  (A TP dim that does
    not divide cannot be placed at all; the steps check the head counts
    they need whole.)"""
    def one(path, leaf):
        name = "/".join(str(k) for k in path)
        if not isinstance(leaf, Sharded):
            return
        if not same_mesh(leaf.mesh, mesh):
            raise ValueError(f"{name}: placed on {leaf.mesh}, not on the step's mesh {mesh}")
        keep = tp_keep(name, leaf.ndim)
        for d, axes in enumerate(leaf.sharding.dim_axes(leaf.ndim)):
            if "model" in axes and d not in keep:
                raise ValueError(f"{name}: split over 'model' on dim {d}; the Megatron layout "
                                 f"splits {sorted(keep) or 'no dim'} of a {leaf.ndim}-dim leaf")

    map_with_path(one, params)


__all__ = ["Shards", "Views", "check_placed", "placed_mesh", "row_sum", "same_mesh", "tp_keep",
           "vocab_parallel_embed"]
