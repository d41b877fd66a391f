"""Decoder-only dense LM with FIER-integrated decode (port of
``repro.models.transformer`` for ``family='dense'``).

* Layer params are stacked along a leading L axis; depth is a Python loop.
* Prefill runs blocked flash attention over the prompt, zero-pads each
  layer's K/V to ``capacity`` and quantizes the whole padded slab of every
  layer past ``skip_layers`` into the FIER side-car.  It always returns a
  slab cache; a paged engine scatters it into its block pool.
* Chunked prefill (``prefill_chunk``) runs one chunk of one slot's prompt
  against the batched cache of either layout.
* Decode splits the stack at ``skip``: the front layers attend densely
  (the paper's skip layers), the rest through the policy's ``DecodePlan``.
  On a paged cache the block table rides in ``cache["block_table"]``.
* The vocab is padded to a multiple of 256; padded columns get −1e30.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.policy import DecodePlan, PolicyConfig, build_metadata
from repro_torch.kvcache import cache as kvcache
from repro_torch.kvcache import paged as kvpaged

from . import attention as attn
from .layers import apply_norm, flash_attention, init_embedding, init_mlp, init_norm, mlp_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable               # (generator | seed) -> params
    prefill: Callable            # (params, batch, capacity) -> (logits [B,Vp], slab cache)
    decode_step: Callable        # (params, token [B], cache) -> (logits, cache)
    init_cache: Callable         # (B, capacity, length) -> cache
    param_count: Callable
    compute_params: Callable     # params -> params with bf16 matmul weights
    device: torch.device
    policy: PolicyConfig | None = None
    plan: DecodePlan | None = None
    prefill_chunk: Callable | None = None  # (params, batch, cache, *, final)
                                           # -> (logits | None, cache)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer_params(layers: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], layers)


def _layer_cache(stack: dict, i: int) -> dict:
    lc = {"k": stack["k"][i], "v": stack["v"][i]}
    if "meta" in stack:
        lc["meta"] = stack["meta"].layer(i)
    return lc


def build(cfg: ModelConfig, pol: PolicyConfig | None = None, *, device="cuda") -> ModelBundle:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    device = torch.device(device)
    pol = pol or PolicyConfig(kind="full")
    plan = DecodePlan.build(pol)
    plan_full = DecodePlan.build(PolicyConfig(
        kind="full", skip_layers=0, layout=pol.layout, block_size=pol.block_size,
        pool_blocks=pol.pool_blocks,
    ))
    paged = pol.layout == "paged"
    Vp = padded_vocab(cfg)
    cdt = _DTYPES[cfg.compute_dtype]
    pdt = _DTYPES[cfg.param_dtype]
    L = cfg.n_layers
    skip = min(pol.skip_layers if pol.kind != "full" else 0, L)

    # ----------------------------------------------------------------- init
    def init(gen: torch.Generator | int) -> dict:
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        params = {
            "embed": init_embedding(gen, Vp, cfg.d_model, device=device),
            "layers": {
                "norm1": init_norm(cfg.norm, cfg.d_model, n=L, device=device),
                "attn": attn.init_attention(gen, cfg, n=L, device=device),
                "norm2": init_norm(cfg.norm, cfg.d_model, n=L, device=device),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, n=L, device=device),
            },
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_embedding(gen, Vp, cfg.d_model, device=device).T.contiguous()
        return tree_map(lambda a: a.to(pdt), params)

    def compute_params(params: dict) -> dict:
        """One compute-dtype copy of every layer matmul weight (what each
        call would otherwise cast to, bit for bit); the embedding, head and
        norms stay as they are — the head multiplies in f32."""
        layers = tree_map(lambda a: a.to(cdt) if a.dim() >= 3 else a, params["layers"])
        return dict(params, layers=layers)

    # ------------------------------------------------------------- helpers
    def _ffn_block(lp, h, attn_out):
        """h + attn_out, then the MLP sub-block on it.  The norm reads the
        f32 residual sum, not its bf16 rounding: compiled, the reference's
        layer (repro/models/transformer.py:185-196, :391-400) elides that
        round trip (XLA's excess precision), and the port mirrors it."""
        r = h.to(torch.float32) + attn_out.to(torch.float32)
        xn = apply_norm(r, lp["norm2"], cfg.norm).to(cdt)
        return r.to(cdt) + mlp_apply(xn, lp["mlp"], cfg.act)

    def _head(params):
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    # ------------------------------------------------------------- prefill
    def prefill(params, batch, capacity: int | None = None):
        """Returns (last-token logits [B, Vp] f32, filled slab cache)."""
        toks = batch["tokens"]
        lengths = batch["lengths"].to(torch.int32)
        h = params["embed"][toks].to(cdt)  # [B, S, d]
        B, S, _ = h.shape
        cap = capacity if capacity is not None else S
        valid = kvcache.valid_mask(S, lengths)
        cache = _slab_cache(B, cap, 0)
        cache["length"] = lengths.clone()
        for l in range(L):
            lp = _layer_params(params["layers"], l)
            xn = apply_norm(h, lp["norm1"], cfg.norm)
            q, k, v = attn.qkv_proj(lp["attn"], xn, cfg, positions=None)
            o = flash_attention(q, k, v, causal=True, bias_mask=valid)
            h = _ffn_block(
                lp, h, o.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["attn"]["wo"].to(h.dtype)
            )
            # K/V zero-padded to capacity, as jnp.pad does at
            # repro/models/transformer.py:192-196 (the slab is zeros beyond S)
            stack, i = (cache["front"], l) if l < skip else (cache["rest"], l - skip)
            stack["k"][i, :, :S] = k.to(torch.bfloat16)
            stack["v"][i, :, :S] = v.to(torch.bfloat16)
        if "meta" in cache["rest"]:
            # the side-car covers the whole zero-padded slab, prompt padding
            # rows included, as _assemble_cache quantizes it
            meta = cache["rest"]["meta"]
            for i in range(L - skip):
                mv = build_metadata(cache["rest"]["k"][i], pol)
                meta.codes[i].copy_(mv.codes)
                meta.scale[i].copy_(mv.scale)
                meta.zero[i].copy_(mv.zero)
        rows = torch.arange(B, device=h.device)
        last = apply_norm(h[rows, lengths.to(torch.int64) - 1], params["final_norm"], cfg.norm)
        return _masked_logits(last, _head(params), cfg.vocab, Vp), cache

    def init_cache(B: int, capacity: int, length: int = 0) -> dict:
        """The batched decode cache of the policy's layout.  Paged: one
        block pool shared by every request (a physical block id indexes the
        same row of every layer's pool) and the per-request [B, capacity/bs]
        block table, all zeros (the null block) to start with."""
        plan.validate_capacity(capacity)
        if not paged:
            return _slab_cache(B, capacity, length)
        bs = pol.block_size
        n_btab = capacity // bs
        n_blocks = pol.pool_blocks or (B * n_btab + 1)
        pool = lambda n, p: kvpaged.init_paged_pool(
            n, n_blocks, bs, cfg.n_kv_heads, cfg.d_head, p, device=device
        )
        return {
            "front": pool(skip, None),
            "rest": pool(L - skip, pol if pol.kind != "full" else None),
            "length": torch.full((B,), length, dtype=torch.int32, device=device),
            "block_table": torch.zeros((B, n_btab), dtype=torch.int32, device=device),
        }

    def _slab_cache(B: int, capacity: int, length: int = 0) -> dict:
        return {
            "front": kvcache.init_layer_cache(
                skip, B, capacity, cfg.n_kv_heads, cfg.d_head, None, device=device
            ),
            "rest": kvcache.init_layer_cache(
                L - skip, B, capacity, cfg.n_kv_heads, cfg.d_head,
                pol if pol.kind != "full" else None, device=device,
            ),
            "length": torch.full((B,), length, dtype=torch.int32, device=device),
        }

    # ------------------------------------------------------ chunked prefill
    def prefill_chunk(params, batch, cache, *, final: bool):
        """One prompt chunk for a single slot of the *batched* cache
        (port of ``repro/models/transformer.py:254-376``), in place.

        batch = {tokens [1, n], start, slot, total, table_row? [n_btab]}:
        the chunk covers logical positions [start, start+n) of a prompt of
        ``total`` tokens.  Its K/V are written through the layout's
        addressing (slab row / block table), then each layer attends over
        the logical prefix with ``q_offset=start`` — masked keys add exact
        zeros, so the hidden states equal a monolithic prefill's.

        Only the final chunk produces logits: it zeroes the slab/tail-block
        rows past ``total`` (as monolithic prefill's zero padding), rebuilds
        the side-car over the full logical key row, and publishes
        ``length[slot] = total`` and (paged) the table row.  Non-final
        chunks return (None, cache) and leave ``length`` untouched."""
        toks = batch["tokens"]
        start, slot, total = int(batch["start"]), int(batch["slot"]), int(batch["total"])
        table_row = batch.get("table_row")
        h = params["embed"][toks].to(cdt)  # [1, n, d]
        n = h.shape[1]
        dev = h.device
        positions = (start + torch.arange(n, dtype=torch.int32, device=dev))[None]
        if paged:
            bs = pol.block_size
            nb = table_row.shape[0]
            ids = table_row.to(torch.int64)
            phys = ids[positions[0].to(torch.int64) // bs]
            offs = positions[0].to(torch.int64) % bs
        for l in range(L):
            lp = _layer_params(params["layers"], l)
            stack, i = (cache["front"], l) if l < skip else (cache["rest"], l - skip)
            kp, vp = stack["k"][i], stack["v"][i]
            xn = apply_norm(h, lp["norm1"], cfg.norm)
            q, k, v = attn.qkv_proj(lp["attn"], xn, cfg, positions=positions)
            kc, vc = k.to(kp.dtype), v.to(vp.dtype)
            if paged:
                kp[phys, offs] = kc[0]
                vp[phys, offs] = vc[0]
                Kl = kvpaged.gather_block_rows(kp, table_row[None])
                Vl = kvpaged.gather_block_rows(vp, table_row[None])
            else:
                kp[slot, start:start + n] = kc[0]
                vp[slot, start:start + n] = vc[0]
                Kl, Vl = kp[slot:slot + 1], vp[slot:slot + 1]
            cap = Kl.shape[1]
            pos = torch.arange(cap, dtype=torch.int32, device=dev)
            o = flash_attention(
                q, Kl, Vl, causal=True, q_offset=start, bias_mask=(pos < start + n)[None]
            )
            h = _ffn_block(
                lp, h, o.reshape(1, n, cfg.n_heads * cfg.d_head) @ lp["attn"]["wo"].to(h.dtype)
            )
            if not final:
                continue
            rmask = (pos < total)[None, :, None, None]
            Kz = torch.where(rmask, Kl, torch.zeros_like(Kl))
            Vz = torch.where(rmask, Vl, torch.zeros_like(Vl))
            if paged:
                # every table entry, the null ones too (they cover rows past
                # `total`, so the null block receives zeros)
                put = lambda pool, val: pool.index_put_(
                    (ids,), val[0].reshape(nb, pool.shape[1], *val.shape[2:]).to(pool.dtype)
                )
            else:
                put = lambda pool, val: pool[slot].copy_(val[0])
            put(kp, Kz)
            put(vp, Vz)
            if "meta" in stack:
                meta, mv = stack["meta"], build_metadata(Kz, pol)
                for name in ("codes", "scale", "zero"):
                    put(getattr(meta, name)[i], getattr(mv, name))
        if not final:
            return None, cache
        cache["length"][slot] = total
        if paged:
            cache["block_table"][slot] = table_row
        last = apply_norm(h[:, n - 1], params["final_norm"], cfg.norm)
        return _masked_logits(last, _head(params), cfg.vocab, Vp), cache

    # -------------------------------------------------------------- decode
    def decode_step(params, token, cache):
        """One token per sequence; the cache is updated in place and
        returned with ``length + 1``."""
        length = cache["length"]
        block_table = cache.get("block_table") if paged else None
        h = params["embed"][token][:, None, :].to(cdt)
        for l in range(L):
            lp = _layer_params(params["layers"], l)
            if l < skip:
                lc, layer_plan = _layer_cache(cache["front"], l), plan_full
            else:
                lc, layer_plan = _layer_cache(cache["rest"], l - skip), plan
            o = attn.decode_self_attention(
                lp["attn"], apply_norm(h, lp["norm1"], cfg.norm), lc, length, cfg,
                layer_plan, block_table=block_table,
            )
            h = _ffn_block(lp, h, o)
        h = apply_norm(h, params["final_norm"], cfg.norm)[:, 0]
        logits = _masked_logits(h, _head(params), cfg.vocab, Vp)
        return logits, dict(cache, length=length + 1)

    return ModelBundle(
        cfg=cfg,
        init=init,
        prefill=prefill,
        decode_step=decode_step,
        init_cache=init_cache,
        param_count=cfg.param_count,
        compute_params=compute_params,
        device=device,
        policy=pol,
        plan=plan,
        prefill_chunk=prefill_chunk,
    )


# ---------------------------------------------------------------- head

def _vocab_col_mask(vocab: int, Vp: int, device) -> torch.Tensor:
    # the -1e30 padded-column mask of repro/models/transformer.py:439-440,
    # added in f32 after the head
    col = torch.arange(Vp, device=device)
    return torch.where(
        col < vocab, torch.tensor(0.0, device=device), torch.tensor(-1e30, device=device)
    )


def _masked_logits(h: torch.Tensor, W: torch.Tensor, vocab: int, Vp: int) -> torch.Tensor:
    logits = h.to(torch.float32) @ W.to(torch.float32)
    return logits + _vocab_col_mask(vocab, Vp, h.device)
