"""GQA attention block: projections, full attention and the decode step.

Port of ``repro.models.attention`` (``DistConfig``, ``init_attention``,
``qkv_proj``, ``attention_train``'s forward, ``decode_self_attention``).
The decode step appends the new token's K/V and refreshes its side-car
group in place (through the block table on a paged cache), then dispatches
attention through ``repro_torch.core.policy`` — shard by shard when the
plan carries a mesh sharding spec (``kvcache.sharded``), or through the
distributed LSE-merge path (``core.distributed``) when the slab cache is
sequence-sharded (``DistConfig.seq_axes``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as dist
from repro_torch.core import policy as core_policy
from repro_torch.core.placement import axis_coords
from repro_torch.core.policy import CacheView, DecodePlan, PolicyConfig
from repro_torch.kvcache import cache as kvcache
from repro_torch.kvcache import paged as kvpaged
from repro_torch.kvcache import sharded as kvsharded

from .layers import apply_rope, flash_attention, init_linear


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """How the model runs across a mesh (``launch.mesh.Mesh``).

    seq_axes: mesh axes the slab cache's *sequence* dim is sharded over at
    decode; empty → the single-shard policy path.  mode: 'local' | 'exact'
    (see ``core.distributed``).  batch_axes: mesh axes the batch splits
    over on that path.  shard: the mesh sharding spec of the *paged* pool
    (``kvcache.sharded.ShardSpec``: TP over KV heads × DP over slots),
    threaded into ``DecodePlan.build`` so the plan carries it; None = one
    device.  In training (a bundle built with a mesh trains over it,
    ``models/sharded_train.py``): batch_axes are the axes the batch splits
    over; ep_axis the mesh axis of MoE expert parallelism
    (``moe.moe_apply_ep``)."""

    mesh: Any = None
    seq_axes: tuple[str, ...] = ()
    mode: str = "local"
    batch_axes: tuple[str, ...] = ()
    ep_axis: str | None = None
    shard: Any = None


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, n: int = 1,
                   d_in: int | None = None, device="cuda",
                   dtype: torch.dtype = torch.float32) -> dict:
    """Attention params stacked over ``n`` layers (``dtype``, f32 by default);
    ``d_in`` is the width the projections read (the hybrid's shared block
    reads 2·d_model), d_model by default."""
    d, Dh = d_in if d_in is not None else cfg.d_model, cfg.d_head
    p = {
        "wq": init_linear(gen, d, cfg.n_heads * Dh, n=n, device=device, dtype=dtype),
        "wk": init_linear(gen, d, cfg.n_kv_heads * Dh, n=n, device=device, dtype=dtype),
        "wv": init_linear(gen, d, cfg.n_kv_heads * Dh, n=n, device=device, dtype=dtype),
        "wo": init_linear(gen, cfg.n_heads * Dh, cfg.d_model, n=n, device=device,
                          dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n, width * Dh), device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def qkv_proj(
    p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → q [B,S,Hq,D], k/v [B,S,Hkv,D] (RoPE applied)."""
    B, S, _ = x.shape
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = _proj(x, p["wk"], p.get("bk")).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    kv_x: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Full attention over a whole sequence (``flash_attention``), the
    forward of the reference's ``attention_train``: x [B, S, d] → [B, S, d];
    ``kv_x`` [B, Sk, d] makes it cross-attention (no RoPE there)."""
    B, S, _ = x.shape
    if kv_x is None:
        q, k, v = qkv_proj(p, x, cfg, positions)
    else:
        Sk = kv_x.shape[1]
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.d_head)
        k = _proj(kv_x, p["wk"], p.get("bk")).reshape(B, Sk, cfg.n_kv_heads, cfg.d_head)
        v = _proj(kv_x, p["wv"], p.get("bv")).reshape(B, Sk, cfg.n_kv_heads, cfg.d_head)
    o = flash_attention(q, k, v, causal=causal, block_k=block_k)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def decode_self_attention(
    p: dict,
    x: torch.Tensor,
    layer_cache: dict,
    length: torch.Tensor,
    cfg: ModelConfig,
    plan: DecodePlan,
    dcfg: DistConfig | None = None,
    *,
    block_table: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token decode self-attention.

    x: [B, 1, d]; layer_cache: {k, v[, meta]} of one layer (views into the
    stacked cache, updated in place); length: [B] current lengths (the new
    token is written at ``length``).  ``block_table`` [B, n_btab] switches
    the layer to the paged cache: layer_cache holds the block-pool slabs
    [N, bs, Hkv, D] (+ paged side-car) shared by all requests, the append
    and the metadata refresh write through the table, and attention
    dispatches through a paged ``CacheView`` — on every shard of the mesh
    when the plan carries a sharding spec (the pool leaves are then
    ``kvcache.sharded.ShardedPool``s).  With ``dcfg.seq_axes`` the slab
    cache is sequence-sharded over those mesh axes: the append, the
    side-car refresh and the attention run per shard, merged by the LSE
    combine (``core.distributed``).  Returns out [B, 1, d]; the output
    projection always runs on the whole [B, Hq·D] row.
    """
    B = x.shape[0]
    q, k_new, v_new = qkv_proj(p, x, cfg, positions=length[:, None])
    qh = q.reshape(B, cfg.n_heads, cfg.d_head)
    meta = layer_cache.get("meta")
    seq_sharded = dcfg is not None and bool(dcfg.seq_axes)
    if block_table is not None and seq_sharded:
        raise ValueError(
            "paged KV cache + sequence-sharded decode is not supported; "
            "shard the paged pool over the mesh instead "
            "(Engine.build(mesh=...) → kvcache.sharded)"
        )
    if block_table is not None and plan.shard is not None:
        out = kvsharded.sharded_paged_decode_step(
            qh, k_new, v_new, layer_cache["k"], layer_cache["v"], meta,
            block_table, length, plan.policy, plan, plan.shard,
        )
    elif block_table is not None:
        k, v = kvpaged.paged_append_kv(
            layer_cache["k"], layer_cache["v"], k_new, v_new, block_table, length
        )
        if meta is not None:
            meta = kvpaged.paged_append_token_metadata(
                meta, k, block_table, length, plan.policy
            )
        out = core_policy.decode_attention(
            qh, CacheView.paged(k, v, meta, block_table, length + 1), plan)
    elif seq_sharded:
        out = _sharded_decode_step(
            qh, k_new, v_new, layer_cache["k"], layer_cache["v"], meta, length,
            plan.policy, dcfg,
        )
    else:
        k, v = kvcache.append_kv(layer_cache["k"], layer_cache["v"], k_new, v_new, length)
        if meta is not None:
            meta = kvcache.append_token_metadata(meta, k, length, plan.policy)
        out = core_policy.decode_attention(qh, CacheView.slab(k, v, meta, length + 1), plan)
    return out.reshape(B, 1, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def _sharded_decode_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    K: torch.Tensor,
    V: torch.Tensor,
    meta: Any,
    length: torch.Tensor,
    pol: PolicyConfig,
    dcfg: DistConfig,
) -> torch.Tensor:
    """Sequence-sharded slab decode: shard-local append + side-car refresh,
    then distributed FIER (or full) attention with the LSE merge.  The slab
    [B, S, Hkv, D] splits into ``dcfg.batch_axes`` row ranges × ``seq_axes``
    position ranges; a shard on the slab's own device works on views of it,
    a shard elsewhere on a copy that is written back after the append.  The
    only collectives are the O(Hq·D) psum of partial outputs (and the small
    candidate all-gather in mode 'exact').  Returns out [B, Hq, D]."""
    mesh, axes, baxes = dcfg.mesh, tuple(dcfg.seq_axes), tuple(dcfg.batch_axes)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    n_b = math.prod(mesh.shape[a] for a in baxes)
    B, S = K.shape[:2]
    if S % n_shards or B % n_b:
        raise ValueError(f"slab [{B}, {S}] does not split into {n_b} × {n_shards} shards")
    S_loc, B_loc = S // n_shards, B // n_b
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    fier = pol.kind == "fier" and meta is not None
    out = torch.empty_like(q)
    for bi in range(n_b):
        rows = slice(bi * B_loc, (bi + 1) * B_loc)
        group = {n: [] for n in ("q", "K", "V", "qk", "len", "start")}
        for si in range(n_shards):
            dev = mesh.device_at({**axis_coords(mesh, baxes, bi),
                                  **axis_coords(mesh, axes, si)})
            start = si * S_loc
            cols = slice(start, start + S_loc)
            home = [K[rows, cols], V[rows, cols]]
            if fier:
                home += [meta.codes[rows, start // 8:(start + S_loc) // 8],
                         meta.scale[rows, start // pol.group:(start + S_loc) // pol.group],
                         meta.zero[rows, start // pol.group:(start + S_loc) // pol.group]]
            local = [t.to(dev) for t in home]
            K_l, V_l = local[:2]
            len_l = length[rows].to(dev)
            # shard-local append: only the owning shard commits the write; the
            # select runs on the one row, never on the slab
            rel = len_l.to(torch.int64) - start
            owns = (rel >= 0) & (rel < S_loc)
            wpos = torch.clamp(rel, 0, S_loc - 1)
            r = torch.arange(B_loc, device=dev)
            for slab, new in ((K_l, k_new), (V_l, v_new)):
                new = new[rows].to(dev, slab.dtype)
                slab[r, wpos] = torch.where(owns[:, None, None], new, slab[r, wpos])
            qk_l = None
            if fier:
                qk_l = dataclasses.replace(meta, codes=local[2], scale=local[3], zero=local[4])
                kvcache.append_token_metadata(qk_l, K_l, wpos, pol, commit_mask=owns)
            for h, l in zip(home, local):
                if l.data_ptr() != h.data_ptr():
                    h.copy_(l)
            group["q"].append(q[rows].to(dev))
            group["K"].append(K_l), group["V"].append(V_l), group["qk"].append(qk_l)
            group["len"].append(len_l + 1), group["start"].append(start)
        if fier:
            res = dist.fier_decode_sharded(
                group["q"], group["K"], group["V"], group["qk"], pol.budget, group["len"],
                shard_start=group["start"], n_shards=n_shards,
                group_reduce=pol.group_reduce, mode=dcfg.mode,
            )
        else:
            res = dist.full_decode_sharded(group["q"], group["K"], group["V"], group["len"],
                                           shard_start=group["start"])
        out[rows] = res[0].to(out.device)
    return out
