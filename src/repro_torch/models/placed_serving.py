"""The transformer family's serving steps on placed params: Megatron-parallel
prefill, chunked prefill and decode over the params' mesh.

A placed param tree is one that ``core.placement.place_tree(params,
launch.sharding.param_shardings(params, mesh, fsdp))`` made: TP over 'model',
FSDP over the data axes.  The reference places its serving params the same
way and GSPMD runs the projections Megatron-parallel; this module is the
port's counterpart, single-controller.  ``models/transformer.build``'s
steps hand a placed tree here; a plain tree keeps the one-device code.

* Each (data shard t, model shard m) computes with the pieces that live on
  it (``tensor_parallel.Views``: its TP block, gathered over the FSDP axes
  only): the vocab-split embedding rows (a psum joins them), its column
  blocks of wq/wk/wv, its rows of wo and w2 (row-parallel: each partial
  product in f32, one psum, ``tensor_parallel.row_sum``), its columns of
  w1/w3, its experts (``moe/*`` split over 'model') and its columns of the
  head, whose [B, Vp] logits are gathered once.
* Only per-row activations cross between shards: the embedding and the
  row-parallel partials (psums); where the cache is not split by heads,
  the new token's q/k/v rows (the column blocks need not hold whole
  heads: RoPE runs after the gather) onto the sequence shards or the
  cache's device, and the attention output's columns back to the model
  shards; in a prefill whose KV heads do not divide over the model shards,
  the K/V (each shard reads the KV heads of its query heads), and where
  its query heads do not divide either, the attention output; the logits;
  and the tokens of a MoE call whose capacity spans data shards.
* Decode, by cache: on the Engine's TP × DP paged pool
  (``kvcache.sharded``; the pool's TP axis must be 'model' and its DP axes
  the data shards) model shard m's Q/K/V columns are exactly its KV
  heads, so each (d, m) shard appends to its own pool part and runs
  K3/K4 (``kvcache.sharded.shard_decode_step``) on inputs it made itself;
  on the sequence-sharded slab (``DistConfig.seq_axes``, a cache placed by
  ``launch.sharding.cache_shardings``) each data shard's new q/k/v rows
  are gathered to its sequence shards (``attention.sharded_decode_rows``);
  on a one-device cache they are gathered onto its device.  MoE decode runs
  each expert shard's experts masked (``moe.moe_apply_masked``) and sums
  the partials over the expert shards.
* Prefill: each data shard takes its batch rows (all rows on one data
  shard when the batch does not divide: the Engine's insert of one request
  runs on its slot's DP shard, ``batch["dp_shard"]``), each model shard
  its query heads (``flash_attention`` over them; an uneven share where
  they do not divide), the FFN is Megatron-parallel
  and the MoE expert-parallel (``moe.moe_apply_ep``; its token shards are
  ``dcfg.batch_axes`` when ``dcfg.ep_axis`` is set, as the reference's
  ``_ffn``, else one token shard over the whole call, the one-device
  capacity).  The cache comes back split by heads over 'model' for the
  Engine's paged pool (each piece written into its own pool part,
  ``Engine._paged_scatter``), placed by ``launch.sharding.cache_shardings``
  for a bundle built on a mesh (K/V handed from head-split to
  sequence-split once per layer by an all-to-all over 'model',
  :func:`heads_to_sequence`, and the FIER side-car built per shard), or
  on the bundle's device otherwise.
* Chunked prefill (one request) runs each model shard's heads against its
  own part of the pool or slab; it needs the heads to divide, as the
  Engine's TP × DP pool does.

A placed tree that cannot take this layout raises naming the leaf and the
reason (``tensor_parallel.check_placed``, and the checks here against the
cache's mesh); no step gathers a TP-split leaf whole.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import padded_vocab
from repro_torch.core import distributed as dist
from repro_torch.core.placement import (NamedSharding, P, Sharded, at_home, index_layer,
                                         map_leaf, place, place_new, split_batch)
from repro_torch.core.policy import build_metadata
from repro_torch.kvcache import cache as kvcache
from repro_torch.kvcache import paged as kvpaged
from repro_torch.kvcache import sharded as kvsharded
from repro_torch.kvcache.sharded import ShardedPool
from repro_torch.launch.sharding import cache_shardings, map_with_path

from . import attention as attn
from . import moe as moe_mod
from . import tensor_parallel as tp
from .layers import apply_norm, apply_rope, flash_attention, gelu, silu
from .transformer import _DTYPES, _logits, _vocab_col_mask, tree_map


def heads_to_sequence(xs: list[torch.Tensor], seq_dim: int, head_dim: int) -> list[torch.Tensor]:
    """The K/V hand-off of a placed prefill: ``xs[m]`` is model shard m's
    heads over the whole sequence; shard s gets sequence block s of every
    shard's heads, joined in head order (``dist.all_to_all``)."""
    return dist.all_to_all(xs, seq_dim, head_dim)


def _layer(tree, i):
    return tree_map(lambda a: index_layer(a, i), tree)


def _rope(x: torch.Tensor, cfg, positions=None) -> torch.Tensor:
    """RoPE on [rows, S, H, D] at ``positions`` (0..S-1, a prefill's, by
    default)."""
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    return apply_rope(x, positions.to(x.device), cfg.rope_theta)


def _attend(q, k, v, valid):
    """A prefill shard's causal flash attention over its query heads (none
    where the heads split unevenly over more shards than heads), each
    512-row query block against every key at once: a shard holds 1/n of
    the heads, so the f32 score block [rows, 512, heads, S] stays small,
    and a trace of every shard runs 1/(S/512) of the blocked loop's ops."""
    if not q.shape[2]:
        return q.new_zeros(q.shape)
    return flash_attention(q, k, v, causal=True, block_k=k.shape[1],
                           bias_mask=valid.to(q.device))


def _row_part(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A model shard's row-parallel partial product in f32 (its bf16
    operands' products are exact there): the psum of the partials then
    rounds once, where the one-device product rounds its f32 sum once."""
    return x.to(torch.float32) @ w.to(torch.float32)


def _col_part(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A model shard's column block of ``x @ w`` in x's dtype, as the
    one-device product computes it (``tools/probe_placed.py`` read a block
    summed in f32 and rounded once no nearer the one-device step on the
    card)."""
    return x @ w.to(x.dtype)


def _mlp_part(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """``layers.mlp_apply`` on a model shard's columns of w1/w3 and rows of
    w2, its last product left in f32 (``_row_part``)."""
    if act == "silu":
        h = silu(_col_part(x, p["w1"])) * _col_part(x, p["w3"])
    elif act == "gelu":
        h = gelu(_col_part(x, p["w1"]))
    else:
        raise ValueError(act)
    return _row_part(h, p["w2"])


def _heads_of(x, d: int, m: int, h: int) -> torch.Tensor:
    """One layer's pool or slab leaf restricted to model shard m's ``h``
    heads (axis 2): a ``ShardedPool``'s part on DP shard d, or a view of a
    plain tensor (writes reach it)."""
    if isinstance(x, ShardedPool):
        return x.parts[d][m]
    return x.narrow(2, m * h, h)


class PlacedSteps:
    """``prefill``, ``prefill_chunk`` and ``decode_step`` of a dense / moe /
    vlm bundle for placed params (module docstring)."""

    def __init__(self, cfg, pol, plan, plan_full, dcfg, skip: int, device, slab_cache):
        self.cfg, self.pol, self.plan, self.plan_full = cfg, pol, plan, plan_full
        self.dcfg, self.skip, self.device = dcfg, skip, device
        self.slab_cache = slab_cache
        self.paged = pol.layout == "paged"
        self.cdt = _DTYPES[cfg.compute_dtype]
        self.Vp = padded_vocab(cfg)
        self.L = cfg.n_layers
        self.is_moe = cfg.family == "moe"

    # ------------------------------------------------------------ the grid
    def _grid(self, params, b_axes):
        """(mesh, Shards) of a placed tree, after checking it can take the
        layout (``tensor_parallel.check_placed``)."""
        mesh = tp.placed_mesh(params)
        tp.check_placed(params, mesh)
        return mesh, tp.Shards(mesh, b_axes, strict=False)

    def _heads_cfg(self, n: int, what: str):
        """The per-model-shard config of a step whose model shards own whole
        heads (``n_heads`` and ``n_kv_heads`` divided by the model degree
        ``n``); raises naming the leaf where they do not divide."""
        cfg = self.cfg
        for name, key, count in (("layers/attn/wq", "n_heads", cfg.n_heads),
                                 ("layers/attn/wk", "n_kv_heads", cfg.n_kv_heads)):
            if count % n:
                raise ValueError(f"{name}: {key} {count} does not divide over {n} model "
                                 f"shards ({what} runs whole heads per model shard)")
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // n,
                                   n_kv_heads=cfg.n_kv_heads // n)

    def _pool_spec(self, mesh):
        """The paged pool's ShardSpec, checked against the params' mesh: its
        TP axis must be 'model' and its mesh the params'."""
        spec = self.plan.shard
        if not tp.same_mesh(spec.mesh, mesh):
            raise ValueError(f"the pool's mesh {spec.mesh} is not the params' mesh {mesh}")
        want = tuple(a for a in ("model",) if a in mesh.shape)
        if tuple(spec.tp_axes) != want:
            raise ValueError(f"the pool splits its KV heads over {spec.tp_axes}, the placed "
                             f"params over {want}: the TP axis must be 'model'")
        return spec

    def _bundle_mesh(self, mesh):
        if not tp.same_mesh(self.dcfg.mesh, mesh):
            raise ValueError(f"the bundle's mesh {self.dcfg.mesh} is not the params' mesh {mesh}")

    def _moe_axis(self) -> str:
        axis = self.dcfg.ep_axis if self.dcfg is not None and self.dcfg.ep_axis else "model"
        if axis != "model":
            raise ValueError(f"the placed experts split over 'model', not ep_axis {axis!r}")
        return axis

    # -------------------------------------------------------------- pieces
    def _embed(self, views, sh, t, E, tokens):
        """Data shard t's token rows [.., d] of the embedding ``E`` in the
        compute dtype."""
        Es = [views.tp(E, "embed", t, m) for m in range(sh.n_tp)]
        return tp.vocab_parallel_embed(Es, tokens).to(self.cdt)

    def _head_logits(self, views, params, sh, t, h):
        """f32 logits [rows, Vp] of data shard t's final hidden rows ``h``,
        each model shard's columns from its own block of the head, gathered
        on the data shard's device."""
        cfg = self.cfg
        col = _vocab_col_mask(cfg.vocab, self.Vp, h.device)
        Vl = self.Vp // sh.n_tp
        parts = []
        for m in range(sh.n_tp):
            W = (views.tp(params["embed"], "embed", t, m).T if cfg.tie_embeddings
                 else views.tp(params["lm_head"], "lm_head", t, m))
            hm = h.to(W.device)
            parts.append(_logits(hm, W) + col[m * Vl:(m + 1) * Vl].to(W.device))
        return dist.gather(parts, 1, sh.dev(t))

    def _ffn(self, lp, views, sh, ts, hs, attn_out, *, decode, tok_axes=None):
        """h + attn_out, then the FFN sub-block (``transformer._ffn_block``
        over the shards): dense Megatron-parallel, MoE masked per expert
        shard in decode, expert-parallel in prefill over ``tok_axes``."""
        cfg, cdt = self.cfg, self.cdt
        rs, xns = [], []
        for t, h, a in zip(ts, hs, attn_out):
            r = h.to(torch.float32) + a.to(torch.float32)
            rs.append(r)
            xns.append(apply_norm(r, views.tree(lp["norm2"], "layers/norm2", t, 0),
                                  cfg.norm).to(cdt))
        if not self.is_moe:
            ys = [tp.row_sum([_mlp_part(xn.to(sh.dev(t, m)),
                                        views.tree(lp["mlp"], "layers/mlp", t, m), cfg.act)
                              for m in range(sh.n_tp)], "w2").to(cdt)
                  for t, xn in zip(ts, xns)]
        elif decode:
            E_loc = cfg.n_experts // sh.n_tp
            ys = []
            for t, xn in zip(ts, xns):
                parts = []
                for m in range(sh.n_tp):
                    x2 = xn.reshape(-1, cfg.d_model).to(sh.dev(t, m))
                    y, _ = moe_mod.moe_apply_masked(
                        x2, views.tree(lp["moe"], "layers/moe", t, m), cfg,
                        experts=slice(m * E_loc, (m + 1) * E_loc))
                    parts.append(y)
                ys.append(tp.row_sum(parts, "moe").to(cdt).reshape(xn.shape))
        else:
            ys = self._moe_prefill(lp, sh, ts, xns, tok_axes)
        return [r.to(cdt) + y.to(r.device) for r, y in zip(rs, ys)]

    def _moe_prefill(self, lp, sh, ts, xns, tok_axes):
        """The expert-parallel MoE of a prefill call: token shards over
        ``tok_axes`` (the data shards' rows when they are the same shards;
        else the call's tokens joined and split evenly over them, as the
        reference's ``shard_map`` splits its flattened tokens)."""
        cfg = self.cfg
        axis = self._moe_axis()
        flats = [xn.reshape(-1, cfg.d_model) for xn in xns]
        if tuple(tok_axes) == sh.b_axes and len(ts) == sh.n_dp:
            ys, _ = moe_mod.moe_apply_ep(flats, lp["moe"], cfg, mesh=sh.mesh,
                                         token_axes=tok_axes, model_axis=axis)
        else:
            x = flats[0] if len(flats) == 1 else dist.gather(flats, 0, flats[0].device)
            y, _ = moe_mod.moe_apply_ep(x, lp["moe"], cfg, mesh=sh.mesh, token_axes=tok_axes,
                                        model_axis=axis)
            ys = list(y.split([f.shape[0] for f in flats]))
        return [y.reshape(xn.shape) for y, xn in zip(ys, xns)]

    def _tok_axes(self):
        """The token axes of the prefill MoE: ``dcfg.batch_axes`` when
        ``dcfg.ep_axis`` is set (the reference's ``_ffn``), else none (one
        capacity over the whole call)."""
        d = self.dcfg
        return tuple(d.batch_axes) if d is not None and d.ep_axis is not None else ()

    # -------------------------------------------------------------- decode
    def decode_step(self, params, token, cache):
        cfg, cdt, L, skip = self.cfg, self.cdt, self.L, self.skip
        mesh = tp.placed_mesh(params)
        block_table = cache.get("block_table") if self.paged else None
        first = cache["rest"]["k"] if L > skip else cache["front"]["k"]
        if self.paged and self.plan.shard is not None:
            kind, b_axes = "pool", self._pool_spec(mesh).dp_axes
        elif isinstance(first, Sharded):
            if not (self.dcfg is not None and self.dcfg.seq_axes):
                raise ValueError("a placed cache decodes on a bundle built with "
                                 "DistConfig.seq_axes")
            self._bundle_mesh(mesh)
            kind, b_axes = "seq", tuple(self.dcfg.batch_axes)
        else:
            kind, b_axes = "home", ()
        mesh, sh = self._grid(params, b_axes)
        cfg_tp = self._heads_cfg(sh.n_tp, "the TP x DP pool") if kind == "pool" else None
        B = token.shape[0]
        if B % sh.n_dp:
            raise ValueError(f"{B} rows do not divide over {sh.n_dp} data shards")
        b = B // sh.n_dp
        ts = list(range(sh.n_dp))
        rows = [slice(t * b, (t + 1) * b) for t in ts]
        # each data shard's tokens and lengths where they lie (a placed
        # cache's lengths split over the batch axes as its rows)
        own = split_batch({"token": token, "length": cache["length"]}, mesh, sh.b_axes)
        lens = [o["length"] for o in own]
        top = tp.Views(sh)
        hs = [self._embed(top, sh, t, params["embed"], o["token"])[:, None, :]
              for t, o in zip(ts, own)]
        Hkv = cfg.n_kv_heads
        for l in range(L):
            lp = _layer(params["layers"], l)
            views = tp.Views(sh)
            if l < skip:
                lc, lplan = kvcache.layer_cache(cache["front"], l), self.plan_full
            else:
                lc, lplan = kvcache.layer_cache(cache["rest"], l - skip), self.plan
            attn_out = []
            for t, r in zip(ts, rows):
                xn = apply_norm(hs[t], views.tree(lp["norm1"], "layers/norm1", t, 0), cfg.norm)
                if kind == "pool":
                    qkv = [self._heads(views, lp, sh, t, xn, name, count, lens[t][:, None])
                           for name, count in (("wq", cfg_tp.n_heads), ("wk", cfg_tp.n_kv_heads),
                                               ("wv", cfg_tp.n_kv_heads))]
                    os = [kvsharded.shard_decode_step(
                        t, m, q[:, 0], k[:, 0], v[:, 0], lc["k"], lc["v"], lc.get("meta"),
                        block_table[r], lens[t], lplan.policy, lplan, B * Hkv).reshape(b, 1, -1)
                        for m, (q, k, v) in enumerate(zip(*qkv))]
                else:
                    os = self._gathered_attend(kind, sh, t, views, lp, xn, lc, lens[t],
                                               block_table, lplan)
                parts = [_row_part(o, views.tp(lp["attn"]["wo"], "layers/attn/wo", t, m).to(cdt))
                         for m, o in enumerate(os)]
                attn_out.append(tp.row_sum(parts, "wo").to(cdt))
            hs = self._ffn(lp, views, sh, ts, hs, attn_out, decode=True)
        logits = []
        for t in ts:
            h = apply_norm(hs[t], top.tree(params["final_norm"], "final_norm", t, 0),
                           cfg.norm)[:, 0]
            logits.append(self._head_logits(top, params, sh, t, h))
        out = logits[0].to(self.device) if len(ts) == 1 else dist.gather(logits, 0, self.device)
        return out, dict(cache, length=map_leaf(lambda n: n + 1, cache["length"]))

    def _columns(self, views, lp, sh, t, x, name):
        """Each model shard's column block of one projection of data shard
        t's rows ``x`` (wq, wk or wv and its bias), on the shard's device.
        Column blocks need not hold whole heads."""
        bias = lp["attn"].get("b" + name[1])
        parts = []
        for m in range(sh.n_tp):
            w = views.tp(lp["attn"][name], f"layers/attn/{name}", t, m)
            xm = x.to(w.device)
            y = _col_part(xm, w)
            if bias is not None:
                y = y + views.tp(bias, f"layers/attn/b{name[1]}", t, m).to(xm.dtype)
            parts.append(y)
        return parts

    def _gathered_attend(self, kind, sh, t, views, lp, xn, lc, length, block_table, lplan):
        """Attention of data shard t where the cache is not split by heads:
        the new token's q/k/v rows (each model shard's column block of the
        projections) gathered onto the sequence shards of its rows (``kind``
        "seq") or onto the cache's device ("home"), RoPE on the whole heads
        there; the output's rows handed back to the model shards as the
        row blocks of wo they multiply.  Returns each model shard's [rows,
        1, Hq·D / n] on its device."""
        cfg = self.cfg
        dev = sh.dev(t) if kind == "seq" else lc["k"].device
        b = xn.shape[0]
        pos = length.to(dev)[:, None]
        q, k, v = (dist.gather(self._columns(views, lp, sh, t, xn, name), 2, dev)
                   .reshape(b, 1, n, cfg.d_head)
                   for name, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                   ("wv", cfg.n_kv_heads)))
        if cfg.use_rope:
            q, k = (apply_rope(x, pos, cfg.rope_theta) for x in (q, k))
        if kind == "seq":
            attn.check_sequence_sharded(lc["k"], lc["v"], self.dcfg)
            out = attn.sharded_decode_rows(t, q[:, 0], k[:, 0], v[:, 0], lc["k"], lc["v"],
                                           lc.get("meta"), length.to(dev), lplan.policy,
                                           self.dcfg)
        else:
            out = attn.decode_attend(q[:, 0], k, v, lc, length.to(dev), lplan,
                                     block_table=block_table)
        o = out.reshape(b, 1, -1)
        c = o.shape[-1] // sh.n_tp
        return [o[..., m * c:(m + 1) * c].to(sh.dev(t, m)) for m in range(sh.n_tp)]

    def _heads(self, views, lp, sh, t, xn, name, n_heads, positions=None):
        """Each model shard's column block of one projection of data shard
        t's rows xn [rows, S, d] as its ``n_heads`` whole heads [rows, S,
        n_heads, D], RoPE applied to q and k at ``positions`` ([rows or 1,
        S]; 0..S-1 by default)."""
        cfg = self.cfg
        b, S = xn.shape[:2]
        out = [y.reshape(b, S, n_heads, cfg.d_head)
               for y in self._columns(views, lp, sh, t, xn, name)]
        if name == "wv" or not cfg.use_rope:
            return out
        return [_rope(y, cfg, positions) for y in out]

    def _gathered(self, views, lp, sh, t, xn, names):
        """Per projection in ``names``, data shard t's whole [rows, S, H, D]
        on every model shard (each shard's column block all-gathered), RoPE
        on q and k."""
        cfg = self.cfg
        b, S = xn.shape[:2]
        out = []
        for name in names:
            H = cfg.n_heads if name == "wq" else cfg.n_kv_heads
            ys = [y.reshape(b, S, H, cfg.d_head)
                  for y in dist.all_gather(self._columns(views, lp, sh, t, xn, name), 2)]
            out.append(ys if name == "wv" or not cfg.use_rope else [_rope(y, cfg) for y in ys])
        return out

    def _kv_read(self, k, v, h0, h1):
        """Of a whole K and V, the KV head each query head in [h0, h1) reads
        (GQA: head i reads KV head i // rep), one per query head."""
        cfg = self.cfg
        kv = torch.arange(h0, h1, device=k.device) // (cfg.n_heads // cfg.n_kv_heads)
        return k.index_select(2, kv), v.index_select(2, kv)

    # ------------------------------------------------------------- prefill
    def prefill(self, params, batch, capacity=None):
        cfg, cdt, L, skip = self.cfg, self.cdt, self.L, self.skip
        mesh = tp.placed_mesh(params)
        if self.paged and self.plan.shard is not None:
            out_kind, b_axes = "heads", self._pool_spec(mesh).dp_axes
        elif self.dcfg is not None and self.dcfg.mesh is not None:
            self._bundle_mesh(mesh)
            out_kind, b_axes = "seq", tuple(self.dcfg.batch_axes)
        else:
            out_kind, b_axes = "home", ()
        mesh, sh = self._grid(params, b_axes)
        # each model shard attends whole query heads: its own column block of
        # wq when the heads divide, else its share of the gathered q; its
        # own KV heads when both divide, else the gathered K/V's heads its
        # queries read (the Engine's pool takes only the first)
        n = sh.n_tp
        kv_split = cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0
        if out_kind == "heads":
            self._heads_cfg(n, "the TP x DP pool")
        heads = [m * cfg.n_heads // n for m in range(n + 1)]
        tensors = {k: v for k, v in batch.items()
                   if k in ("tokens", "lengths", "vision_embeds") and v is not None}
        B = tensors["lengths"].shape[0]
        if B % sh.n_dp == 0:
            ts = list(range(sh.n_dp))
            slices = split_batch(tensors, mesh, sh.b_axes)
        else:
            d0 = int(batch.get("dp_shard", 0))
            ts = [d0]
            slices = [{k: at_home(v, self.device).to(sh.dev(d0)) for k, v in tensors.items()}]
        b = B // len(ts)
        top = tp.Views(sh)
        hs, valids, lens = [], [], []
        for t, sl in zip(ts, slices):
            h = self._embed(top, sh, t, params["embed"], sl["tokens"])
            if sl.get("vision_embeds") is not None:
                h = torch.cat([sl["vision_embeds"].to(h.device, cdt), h], dim=1)
            hs.append(h)
            lens.append(sl["lengths"].to(torch.int32))
            valids.append(kvcache.valid_mask(h.shape[1], lens[-1]))
        S = hs[0].shape[1]
        cap = capacity if capacity is not None else S
        store = _CacheOut(self, out_kind, sh, ts, B, b, cap, S, lens)
        tok_axes = self._tok_axes()
        for l in range(L):
            lp = _layer(params["layers"], l)
            views = tp.Views(sh)
            attn_out = []
            for i, t in enumerate(ts):
                xn = apply_norm(hs[i], views.tree(lp["norm1"], "layers/norm1", t, 0), cfg.norm)
                if kv_split:  # each model shard's own heads
                    qs, ks, vs = (self._heads(views, lp, sh, t, xn, name, count // n)
                                  for name, count in (("wq", cfg.n_heads),
                                                      ("wk", cfg.n_kv_heads),
                                                      ("wv", cfg.n_kv_heads)))
                    reads = list(zip(qs, ks, vs))
                else:
                    ks, vs = self._gathered(views, lp, sh, t, xn, ("wk", "wv"))
                    if cfg.n_heads % n:
                        qs = [q[:, :, heads[m]:heads[m + 1]] for m, q in
                              enumerate(self._gathered(views, lp, sh, t, xn, ("wq",))[0])]
                    else:
                        qs = self._heads(views, lp, sh, t, xn, "wq", cfg.n_heads // n)
                    reads = [(q,) + self._kv_read(k, v, heads[m], heads[m + 1])
                             for m, (q, k, v) in enumerate(zip(qs, ks, vs))]
                os = [_attend(q, k, v, valids[i]).reshape(b, S, -1) for q, k, v in reads]
                if not kv_split and cfg.n_heads % n:
                    # the query heads split unevenly: each model shard takes
                    # the columns of the whole output its rows of wo multiply
                    whole = dist.all_gather(os, 2)
                    c = whole[0].shape[-1] // n
                    os = [o[..., m * c:(m + 1) * c] for m, o in enumerate(whole)]
                parts = [_row_part(o, views.tp(lp["attn"]["wo"], "layers/attn/wo", t, m).to(cdt))
                         for m, o in enumerate(os)]
                attn_out.append(tp.row_sum(parts, "wo").to(cdt))
                store.put(l, i, [k.to(torch.bfloat16) for k in ks],
                          [v.to(torch.bfloat16) for v in vs], whole=not kv_split)
            hs = self._ffn(lp, views, sh, ts, hs, attn_out, decode=False, tok_axes=tok_axes)
        cache = store.finish()
        logits = []
        for t, h, ln in zip(ts, hs, lens):
            last = h[torch.arange(b, device=h.device), ln.to(h.device, torch.int64) - 1]
            last = apply_norm(last, top.tree(params["final_norm"], "final_norm", t, 0), cfg.norm)
            logits.append(self._head_logits(top, params, sh, t, last))
        out = logits[0].to(self.device) if len(ts) == 1 else dist.gather(logits, 0, self.device)
        return out, cache

    # ------------------------------------------------------ chunked prefill
    def prefill_chunk(self, params, batch, cache, *, final: bool):
        """``transformer.build``'s ``prefill_chunk`` (one slot's chunk, in
        place) with each model shard's heads run against its own part of
        the pool (a sharded engine's, on the slot's DP shard) or its heads
        of a one-device pool or slab."""
        cfg, cdt, L, skip, pol = self.cfg, self.cdt, self.L, self.skip, self.pol
        mesh = tp.placed_mesh(params)
        first = cache["rest"]["k"] if L > skip else cache["front"]["k"]
        if isinstance(first, Sharded):
            raise ValueError("chunked prefill runs on a paged pool or a one-device slab, not on "
                             "a sequence-sharded cache")
        sharded_pool = isinstance(first, ShardedPool)
        toks = batch["tokens"]
        start, slot, total = int(batch["start"]), int(batch["slot"]), int(batch["total"])
        table_row = batch.get("table_row")
        d0 = 0
        if sharded_pool:
            spec = self._pool_spec(mesh)
            d0 = int(table_row[0]) // first.n_local
            b_axes = spec.dp_axes
        else:
            b_axes = ()
        mesh, sh = self._grid(params, b_axes)
        cfg_tp = self._heads_cfg(sh.n_tp, "a chunked prefill")
        h_kv = cfg_tp.n_kv_heads
        top = tp.Views(sh)
        home = sh.dev(d0)
        h = self._embed(top, sh, d0, params["embed"], at_home(toks, self.device).to(home))  # [1, n, d]
        n = h.shape[1]
        positions = (start + torch.arange(n, dtype=torch.int32, device=home))[None]
        if self.paged:
            bs = pol.block_size
            nb = table_row.shape[0]
            ids = (kvsharded.localize_block_table(table_row, d0, first.n_local, first.spec.n_dp)
                   if sharded_pool else table_row).to(torch.int64)
            pos = positions[0].to(ids.device, torch.int64)
            phys, offs = ids[pos // bs], pos % bs
        tok_axes = self._tok_axes()
        for l in range(L):
            lp = _layer(params["layers"], l)
            views = tp.Views(sh)
            stack, i = (cache["front"], l) if l < skip else (cache["rest"], l - skip)
            xn = apply_norm(h, views.tree(lp["norm1"], "layers/norm1", d0, 0), cfg.norm)
            qkv = [self._heads(views, lp, sh, d0, xn, name, count, positions)
                   for name, count in (("wq", cfg_tp.n_heads), ("wk", h_kv), ("wv", h_kv))]
            parts = []
            for m, (q, k, v) in enumerate(zip(*qkv)):
                dev = sh.dev(d0, m)
                kp, vp = (_heads_of(stack[name][i], d0, m, h_kv) for name in ("k", "v"))
                kc, vc = k.to(kp.device, kp.dtype), v.to(vp.device, vp.dtype)
                if self.paged:
                    kp[phys.to(kp.device), offs.to(kp.device)] = kc[0]
                    vp[phys.to(vp.device), offs.to(vp.device)] = vc[0]
                    Kl = kvpaged.gather_block_rows(kp, ids[None].to(kp.device))
                    Vl = kvpaged.gather_block_rows(vp, ids[None].to(vp.device))
                else:
                    kp[slot, start:start + n] = kc[0]
                    vp[slot, start:start + n] = vc[0]
                    Kl, Vl = kp[slot:slot + 1], vp[slot:slot + 1]
                cap = Kl.shape[1]
                kpos = torch.arange(cap, dtype=torch.int32, device=dev)
                o = flash_attention(q, Kl.to(dev), Vl.to(dev), causal=True, q_offset=start,
                                    bias_mask=(kpos < start + n)[None])
                wo = views.tp(lp["attn"]["wo"], "layers/attn/wo", d0, m)
                parts.append(_row_part(o.reshape(1, n, -1), wo.to(cdt)))
                if final:
                    self._final_rows(stack, i, d0, m, h_kv, kp, vp, Kl, Vl, total, slot,
                                     ids if self.paged else None)
            a = tp.row_sum(parts, "wo").to(cdt)
            h = self._ffn(lp, views, sh, [d0], [h], [a], decode=False, tok_axes=tok_axes)[0]
        if not final:
            return None, cache
        cache["length"][slot] = total
        if self.paged:
            cache["block_table"][slot] = table_row
        last = apply_norm(h[:, n - 1], top.tree(params["final_norm"], "final_norm", d0, 0),
                          cfg.norm)
        return self._head_logits(top, params, sh, d0, last).to(self.device), cache

    def _final_rows(self, stack, i, d0, m, h_kv, kp, vp, Kl, Vl, total, slot, ids):
        """The final chunk's clean-up on model shard m's heads: rows past
        ``total`` zeroed (as a monolithic prefill's padding) and the
        side-car rebuilt over the whole logical row."""
        cap = Kl.shape[1]
        rmask = (torch.arange(cap, device=Kl.device) < total)[None, :, None, None]
        Kz = torch.where(rmask, Kl, torch.zeros_like(Kl))
        Vz = torch.where(rmask, Vl, torch.zeros_like(Vl))
        if ids is not None:
            nb = ids.shape[0]
            idl = ids.to(Kl.device)

            def put(pool, val):
                pool.index_put_((idl.to(pool.device),), val[0].reshape(
                    nb, pool.shape[1], *val.shape[2:]).to(pool.device, pool.dtype))
        else:
            def put(pool, val):
                pool[slot].copy_(val[0])
        put(kp, Kz)
        put(vp, Vz)
        if "meta" in stack:
            meta, mv = stack["meta"], build_metadata(Kz, self.pol)
            for name in meta.FIELDS:
                put(_heads_of(getattr(meta, name)[i], d0, m, h_kv), getattr(mv, name))


@dataclasses.dataclass(frozen=True)
class _Like:
    """A leaf's shape and dtype, with no storage: what ``place_new`` and
    ``cache_shardings`` read."""

    shape: tuple
    dtype: torch.dtype


class _CacheOut:
    """Where a placed prefill's K/V go, layer by layer (module docstring):
    ``heads`` pieces split over 'model' (the Engine's paged pool), ``seq``
    a cache placed by ``cache_shardings`` (handed from heads to sequence
    per layer, the side-car built per shard), or ``home`` one cache on the
    bundle's device."""

    def __init__(self, steps: PlacedSteps, kind, sh, ts, B, b, cap, S, lens):
        self.steps, self.kind, self.sh, self.ts = steps, kind, sh, ts
        self.B, self.b, self.cap, self.S = B, b, cap, S
        self.lens = lens
        pol, cfg = steps.pol, steps.cfg
        # the slab cache's shapes and dtypes, nothing allocated
        like = lambda shape, dtype, device: _Like(tuple(shape), dtype)
        layers = lambda n, p: kvcache.init_layer_cache(n, B, cap, cfg.n_kv_heads, cfg.d_head, p,
                                                       zeros=like)
        meta_cache = {"front": layers(steps.skip, None),
                      "rest": layers(steps.L - steps.skip, pol if pol.kind != "full" else None),
                      "length": _Like((B,), torch.int32)}
        self.split_rows = len(ts) == sh.n_dp  # the rows split over the data shards
        mesh = sh.mesh
        if kind == "home":
            self.cache = steps.slab_cache(B, cap, 0, steps.device)
            return
        b_ax = sh.b_axes if self.split_rows else ()
        if kind == "heads":
            h = "model" if "model" in mesh.shape else None
            sharding = lambda leaf: NamedSharding(mesh, P(None, b_ax or None, None, h, None))
            self.cache = map_with_path(
                lambda path, leaf: (place_new(leaf, sharding(leaf), fill=0) if path[-1] != "length"
                                    else leaf), meta_cache)
        else:
            seq = tuple(steps.dcfg.seq_axes) or tuple(a for a in ("model",) if a in mesh.shape)
            if seq not in ((), ("model",)):
                raise ValueError(f"a placed prefill hands its K/V from heads to sequence over "
                                 f"'model', not over {seq}")
            self.seq = seq
            axes = map_with_path(lambda path, leaf: 0 if path[-1] == "length" else 1, meta_cache)
            shs = cache_shardings(meta_cache, mesh, b_ax, seq, axes)
            self.cache = map_with_path(
                lambda path, leaf, s: place_new(leaf, s, fill=0) if path[-1] != "length" else leaf,
                meta_cache, shs)
            self.length_sharding = shs["length"]
        self.cache["length"] = None

    def _stack(self, l):
        skip = self.steps.skip
        return (self.cache["front"], l) if l < skip else (self.cache["rest"], l - skip)

    def put(self, l, i, ks, vs, whole=False):
        """Layer l's K/V of data shard ``ts[i]``, bf16, per model shard on
        its device: its heads [b, S, Hkv/n, D], or (``whole``) a copy of
        every head [b, S, Hkv, D]."""
        stack, j = self._stack(l)
        t, rows = self.ts[i], slice(i * self.b, (i + 1) * self.b)
        S, sh = self.S, self.sh
        bi = i if self.split_rows else 0
        if self.kind == "home":
            dev = self.steps.device
            for name, xs in (("k", ks), ("v", vs)):
                stack[name][j, rows, :S] = xs[0].to(dev) if whole else dist.gather(xs, 2, dev)
            return
        if self.kind == "heads":
            for name, xs in (("k", ks), ("v", vs)):
                for m, x in enumerate(xs):
                    piece = stack[name].piece((0, bi, 0, m, 0))
                    piece[j, :, :S] = x.to(piece.device)
            if "meta" in stack:
                for m in range(sh.n_tp):
                    K = stack["k"].piece((0, bi, 0, m, 0))[j]
                    self._meta_into(stack["meta"], j, (0, bi, 0, m, 0), K)
            return
        n_s = sh.n_tp if self.seq else 1
        S_loc = self.cap // n_s
        for name, xs in (("k", ks), ("v", vs)):
            padded = []
            for x in xs:
                full = torch.zeros((x.shape[0], self.cap, *x.shape[2:]), dtype=x.dtype,
                                   device=x.device)
                full[:, :S] = x
                padded.append(full)
            if whole:  # sequence shard s cuts its block from its own copy
                got = [padded[s].narrow(1, s * S_loc, S_loc) for s in range(n_s)]
            elif n_s > 1:
                got = heads_to_sequence(padded, 1, 2)
            else:
                got = [dist.gather(padded, 2, sh.dev(t))]
            for s, x in enumerate(got):
                piece = stack[name].piece((0, bi, s, 0, 0))
                piece[j] = x.to(piece.device)
        if "meta" in stack:
            for s in range(n_s):
                K = stack["k"].piece((0, bi, s, 0, 0))[j]
                self._meta_into(stack["meta"], j, (0, bi, s, 0, 0), K)

    def _meta_into(self, meta, j, block, K):
        mv = build_metadata(K, self.steps.pol)
        for name in meta.FIELDS:
            getattr(meta, name).piece(block)[j].copy_(getattr(mv, name))

    def finish(self) -> dict:
        lengths = torch.cat([n.to(self.steps.device) for n in self.lens])
        cache = self.cache
        if self.kind == "home":
            cache["length"] = lengths
            if "meta" in cache["rest"]:
                meta = cache["rest"]["meta"]
                for i in range(self.steps.L - self.steps.skip):
                    mv = build_metadata(cache["rest"]["k"][i], self.steps.pol)
                    for name in meta.FIELDS:
                        getattr(meta, name)[i].copy_(getattr(mv, name))
        elif self.kind == "heads":
            cache["length"] = lengths
        else:
            cache["length"] = place(lengths, self.length_sharding)
        return cache


__all__ = ["PlacedSteps", "heads_to_sequence"]
