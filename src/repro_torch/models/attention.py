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
from repro_torch.core.placement import Sharded
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
    """One-token decode self-attention: the projections, ``decode_attend``
    and the output projection on the whole [B, Hq·D] row.  x: [B, 1, d];
    returns out [B, 1, d].  (The placed serving step,
    ``models/transformer.py``, projects per model shard and calls
    ``decode_attend`` or ``kvcache.sharded.shard_decode_step`` itself.)"""
    B = x.shape[0]
    q, k_new, v_new = qkv_proj(p, x, cfg, positions=length[:, None])
    out = decode_attend(q.reshape(B, cfg.n_heads, cfg.d_head), k_new, v_new, layer_cache,
                        length, plan, dcfg, block_table=block_table)
    return out.reshape(B, 1, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def decode_attend(
    qh: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer_cache: dict,
    length: torch.Tensor,
    plan: DecodePlan,
    dcfg: DistConfig | None = None,
    *,
    block_table: torch.Tensor | None = None,
) -> torch.Tensor:
    """The new token's attention over one layer's cache.

    qh: [B, Hq, D]; k_new/v_new [B, 1, Hkv, D]; layer_cache: {k, v[, meta]}
    of one layer (views into the stacked cache, updated in place); length:
    [B] current lengths (the new token is written at ``length``).
    ``block_table`` [B, n_btab] switches the layer to the paged cache:
    layer_cache holds the block-pool slabs [N, bs, Hkv, D] (+ paged
    side-car) shared by all requests, the append and the metadata refresh
    write through the table, and attention dispatches through a paged
    ``CacheView`` — on every shard of the mesh when the plan carries a
    sharding spec (the pool leaves are then ``kvcache.sharded.ShardedPool``s).
    With ``dcfg.seq_axes`` the slab cache is sequence-sharded over those
    mesh axes, placed by ``launch.sharding.cache_shardings`` (its leaves
    ``Sharded``): the append, the side-car refresh and the attention run per
    shard on its pieces, merged by the LSE combine (``core.distributed``).
    Returns out [B, Hq, D].
    """
    meta = layer_cache.get("meta")
    seq_sharded = dcfg is not None and bool(dcfg.seq_axes)
    if block_table is not None and seq_sharded:
        raise ValueError(
            "paged KV cache + sequence-sharded decode is not supported; "
            "shard the paged pool over the mesh instead "
            "(Engine.build(mesh=...) → kvcache.sharded)"
        )
    if block_table is not None and plan.shard is not None:
        return kvsharded.sharded_paged_decode_step(
            qh, k_new, v_new, layer_cache["k"], layer_cache["v"], meta,
            block_table, length, plan.policy, plan, plan.shard,
        )
    if block_table is not None:
        k, v = kvpaged.paged_append_kv(
            layer_cache["k"], layer_cache["v"], k_new, v_new, block_table, length
        )
        if meta is not None:
            meta = kvpaged.paged_append_token_metadata(
                meta, k, block_table, length, plan.policy
            )
        return core_policy.decode_attention(
            qh, CacheView.paged(k, v, meta, block_table, length + 1), plan)
    if seq_sharded or isinstance(layer_cache["k"], Sharded):
        if not (seq_sharded and isinstance(layer_cache["k"], Sharded)):
            raise ValueError("the sequence-sharded decode takes DistConfig.seq_axes and a "
                             "cache placed by launch.sharding.cache_shardings")
        return _sharded_decode_step(
            qh, k_new, v_new, layer_cache["k"], layer_cache["v"], meta, length,
            plan.policy, dcfg,
        )
    k, v = kvcache.append_kv(layer_cache["k"], layer_cache["v"], k_new, v_new, length)
    if meta is not None:
        meta = kvcache.append_token_metadata(meta, k, length, plan.policy)
    return core_policy.decode_attention(qh, CacheView.slab(k, v, meta, length + 1), plan)


def _sharded_decode_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    K: Sharded,
    V: Sharded,
    meta: Any,
    length: torch.Tensor,
    pol: PolicyConfig,
    dcfg: DistConfig,
) -> torch.Tensor:
    """Sequence-sharded slab decode over a cache placed by
    ``launch.sharding.cache_shardings``: ``sharded_decode_rows`` for each
    batch shard of q [B, Hq, D], the results joined on q's device."""
    n_b = check_sequence_sharded(K, V, dcfg)
    B_loc = K.shape[0] // n_b
    out = torch.empty_like(q)
    for bi in range(n_b):
        rows = slice(bi * B_loc, (bi + 1) * B_loc)
        res = sharded_decode_rows(bi, q[rows], k_new[rows], v_new[rows], K, V, meta,
                                  length[rows], pol, dcfg)
        out[rows] = res.to(out.device)
    return out


def check_sequence_sharded(K: Sharded, V: Sharded, dcfg: DistConfig) -> int:
    """The number of batch shards of a slab placed by
    ``launch.sharding.cache_shardings`` over ``dcfg``'s batch × sequence
    axes; raises when the slab is split otherwise."""
    mesh, axes, baxes = dcfg.mesh, tuple(dcfg.seq_axes), tuple(dcfg.batch_axes)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    n_b = math.prod(mesh.shape[a] for a in baxes)
    B, S = K.shape[:2]
    if K.grid != (n_b, n_shards, 1, 1) or V.grid != K.grid:
        raise ValueError(f"the slab [{B}, {S}] is split {K.grid}, not into {n_b} row x "
                         f"{n_shards} position blocks over {baxes} x {axes}: place the cache "
                         f"with launch.sharding.cache_shardings")
    return n_b


def sharded_decode_rows(
    bi: int,
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    K: Sharded,
    V: Sharded,
    meta: Any,
    length: torch.Tensor,
    pol: PolicyConfig,
    dcfg: DistConfig,
) -> torch.Tensor:
    """Batch shard ``bi``'s share of the sequence-sharded slab decode: K, V
    [B, S, Hkv, D] and the FIER side-car split into ``dcfg.batch_axes`` row
    blocks × ``seq_axes`` position blocks, each piece on its shard's device
    from ``init_cache`` on; q [B_loc, Hq, D], k_new/v_new [B_loc(, 1), Hkv,
    D] and length [B_loc] are the batch shard's rows.  Per shard, the append
    and the side-car refresh run on its own pieces where they lie, then
    distributed FIER (or full) attention with the LSE merge.  Only q, the
    new K/V row and the lengths reach the shards, and the O(Hq·D) partial
    outputs leave them (plus the small candidate all-gather in mode
    'exact'); no slab range moves.  Returns out [B_loc, Hq, D] on the first
    sequence shard's device."""
    axes = tuple(dcfg.seq_axes)
    n_shards = math.prod(dcfg.mesh.shape[a] for a in axes)
    S_loc = K.shape[1] // n_shards
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    B_loc = q.shape[0]
    fier = pol.kind == "fier" and meta is not None
    group = {n: [] for n in ("q", "K", "V", "qk", "len", "start")}
    for si in range(n_shards):
        block = (bi, si, 0, 0)
        K_l, V_l = K.piece(block), V.piece(block)
        dev = K_l.device
        start = si * S_loc
        len_l = length.to(dev)
        # shard-local append: only the owning shard commits the write; the
        # select runs on the one row, never on the slab
        rel = len_l.to(torch.int64) - start
        owns = (rel >= 0) & (rel < S_loc)
        wpos = torch.clamp(rel, 0, S_loc - 1)
        r = torch.arange(B_loc, device=dev)
        for slab, new in ((K_l, k_new), (V_l, v_new)):
            new = new.to(dev, slab.dtype)
            slab[r, wpos] = torch.where(owns[:, None, None], new, slab[r, wpos])
        qk_l = None
        if fier:
            qk_l = dataclasses.replace(meta, **{f: getattr(meta, f).piece(block)
                                                for f in meta.FIELDS})
            kvcache.append_token_metadata(qk_l, K_l, wpos, pol, commit_mask=owns)
        group["q"].append(q.to(dev))
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
    return res[0]
