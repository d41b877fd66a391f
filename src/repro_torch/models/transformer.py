"""Decoder-only LM with FIER-integrated decode: the port of
``repro.models.transformer`` for the families it builds, ``dense``,
``moe`` (a routed-expert FFN, ``models/moe.py``) and ``vlm`` (the decoder
of a vision-language model: prefill takes precomputed vision embeddings
[B, n_vision_tokens, d] as a prefix of the sequence).

* Layer params are stacked along a leading L axis; depth is a Python loop.
* ``train_loss`` runs the whole sequence through every layer (flash
  attention with its blockwise backward), each layer rematerialised in the
  backward when ``remat`` (``torch.utils.checkpoint``, the reference's
  ``jax.checkpoint(..., nothing_saveable)``), then a sequence-chunked
  cross-entropy that recomputes each chunk's logits in the backward.  Layer
  weights are cast from the f32 master params inside the graph.
* Prefill runs blocked flash attention over the prompt, zero-pads each
  layer's K/V to ``capacity`` and builds the policy's side-car (the FIER
  codes or the Quest page min/max) over the whole padded slab of every
  layer past ``skip_layers``.  It always returns a
  slab cache; a paged engine scatters it into its block pool.
* Chunked prefill (``prefill_chunk``) runs one chunk of one slot's prompt
  against the batched cache of either layout.
* Decode splits the stack at ``skip``: the front layers attend densely
  (the paper's skip layers), the rest through the policy's ``DecodePlan``.
  On a paged cache the block table rides in ``cache["block_table"]``.
* A ``DistConfig`` (``attention.DistConfig``) threads the mesh through:
  its ``shard`` spec rides on both plans of a paged layout (the front
  layers share the sharded pool), and its ``seq_axes`` shard the slab
  cache's sequence in the layers past ``skip``.
* The vocab is padded to a multiple of 256; padded columns get −1e30.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.policy import DecodePlan, PolicyConfig, build_metadata
from repro_torch.kvcache import cache as kvcache
from repro_torch.kvcache import paged as kvpaged
from repro_torch.core.placement import AtUse, Sharded, resolve_at_use

from . import attention as attn
from . import moe as moe_mod
from .layers import apply_norm, flash_attention, init_embedding, init_mlp, init_norm, mlp_apply

FAMILIES = ("dense", "moe", "vlm")  # what build() takes
MOE_AUX_COEF = 0.01

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
    train_loss: Callable | None = None     # (params, batch) -> (loss, metrics)
    dcfg: Any = None                       # the attention.DistConfig it was built with
    train_hidden: Callable | None = None   # (params, batch) -> (final hidden, head, aux)
    loss_chunk: int = 1024                 # train_loss's sequence chunk of the CE


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer_params(layers: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], layers)


def unstack(tree: dict, n: int) -> list[dict]:
    """The n per-layer trees of a tree stacked along axis 0, through one
    ``torch.unbind`` per leaf: its backward stacks the layers' gradients
    once, where indexing each layer would add a full-size zero gradient per
    layer.  A mesh's sharded leaf (``core.placement.Sharded`` or
    ``AtUse``) unstacks piece by piece."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (Sharded, AtUse)):
        return tree.unstack(n)
    return list(torch.unbind(tree, 0))


def checkpointed(fn: Callable, enabled: bool) -> Callable:
    """``fn`` recomputed in the backward instead of keeping its activations
    (the reference's ``jax.checkpoint``), when ``enabled``.  Either way an
    ``AtUse`` argument (a data shard's FSDP-stored layer weights) is
    gathered inside, so with ``enabled`` the backward regathers it."""
    run = lambda *args: fn(*resolve_at_use(args))
    if not enabled:
        return run
    # the models draw no random numbers, so the RNG state need not be kept
    return lambda *args: checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _layer_cache(stack: dict, i: int) -> dict:
    lc = {"k": stack["k"][i], "v": stack["v"][i]}
    if "meta" in stack:
        lc["meta"] = stack["meta"].layer(i)
    return lc


def build(cfg: ModelConfig, pol: PolicyConfig | None = None,
          dcfg: attn.DistConfig | None = None, *, device="cuda",
          remat: bool = True, loss_chunk: int = 1024) -> ModelBundle:
    if cfg.family not in FAMILIES:
        raise ValueError(f"transformer.build takes {FAMILIES}, not {cfg.family!r} "
                         f"(models.model_zoo.build_model dispatches the others)")
    device = device_ = torch.device(device)
    pol = pol or PolicyConfig(kind="full")
    # a mesh sharding spec (dcfg.shard) rides on the plans of a paged layout;
    # the front layers share the sharded pool, so plan_full carries it too
    shard = dcfg.shard if dcfg is not None and pol.layout == "paged" else None
    plan = DecodePlan.build(pol, shard=shard)
    plan_full = DecodePlan.build(PolicyConfig(
        kind="full", skip_layers=0, layout=pol.layout, block_size=pol.block_size,
        pool_blocks=pol.pool_blocks,
    ), shard=shard)
    paged = pol.layout == "paged"
    Vp = padded_vocab(cfg)
    cdt = _DTYPES[cfg.compute_dtype]
    pdt = _DTYPES[cfg.param_dtype]
    L = cfg.n_layers
    skip = min(pol.skip_layers if pol.kind != "full" else 0, L)
    is_moe = cfg.family == "moe"

    # ----------------------------------------------------------------- init
    def init(gen: torch.Generator | int) -> dict:
        """Every leaf drawn in f32 in the reference's order and cast to
        ``param_dtype`` before the next is drawn, so a bf16-param model never
        holds its tree in f32 (the same bits as casting the f32 tree)."""
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        params = {
            "embed": init_embedding(gen, Vp, cfg.d_model, device=device, dtype=pdt),
            "layers": {
                "norm1": init_norm(cfg.norm, cfg.d_model, n=L, device=device),
                "attn": attn.init_attention(gen, cfg, n=L, device=device, dtype=pdt),
                "norm2": init_norm(cfg.norm, cfg.d_model, n=L, device=device),
            },
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=device),
        }
        if is_moe:
            params["layers"]["moe"] = moe_mod.init_moe(gen, cfg, n=L, device=device, dtype=pdt)
        else:
            params["layers"]["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, n=L,
                                               device=device, dtype=pdt)
        if not cfg.tie_embeddings:
            params["lm_head"] = init_embedding(gen, Vp, cfg.d_model, device=device,
                                               dtype=pdt).T.contiguous()
        return tree_map(lambda a: a.to(pdt), params)  # the norms (and biases)

    def compute_params(params: dict) -> dict:
        """One compute-dtype copy of every layer matmul weight (what each
        call would otherwise cast to, bit for bit); the embedding, head,
        norms and the MoE router stay as they are — the head and the router
        multiply in f32."""
        layers = tree_map(lambda a: a.to(cdt) if a.dim() >= 3 else a, params["layers"])
        if is_moe:
            layers["moe"]["router"] = params["layers"]["moe"]["router"]
        return dict(params, layers=layers)

    # ------------------------------------------------------------- helpers
    def _ffn_block(lp, h, attn_out, decode: bool = False):
        """h + attn_out, then the FFN sub-block on it; returns (h, the MoE
        aux loss or None).  The norm reads the f32 residual sum, not its
        bf16 rounding: compiled, the reference's layer
        (repro/models/transformer.py:185-196, :391-400) elides that round
        trip (XLA's excess precision), and the port mirrors it.  MoE
        dispatches as the reference's ``_ffn`` (:129-145): the dense-masked
        experts in decode, the capacity scatter over every position of the
        call (prompt padding included) in training, prefill and chunked
        prefill."""
        r = h.to(torch.float32) + attn_out.to(torch.float32)
        xn = apply_norm(r, lp["norm2"], cfg.norm).to(cdt)
        if not is_moe:
            return r.to(cdt) + mlp_apply(xn, lp["mlp"], cfg.act), None
        apply = moe_mod.moe_apply_masked if decode else moe_mod.moe_apply
        y, aux = apply(xn.reshape(-1, cfg.d_model), lp["moe"], cfg)
        return r.to(cdt) + y.reshape(xn.shape), aux

    def _head(params):
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    # --------------------------------------------------------------- train
    def _embed_inputs(params, batch):
        """Token embeddings in the compute dtype, after the vision prefix
        [B, n_vision, d] when the batch has one."""
        h = params["embed"][batch["tokens"]].to(cdt)
        if batch.get("vision_embeds") is not None:
            h = torch.cat([batch["vision_embeds"].to(cdt), h], dim=1)
        return h

    def _layer_train(h, lp):
        a = attn.attention_train(lp["attn"], apply_norm(h, lp["norm1"], cfg.norm), cfg)
        h, aux = _ffn_block(lp, h, a)
        return h, (torch.zeros((), device=h.device) if aux is None else aux)

    layer_train = checkpointed(_layer_train, remat)

    def train_hidden(params, batch):
        """(the final-normed hidden states [B, S, d], the head [d, Vp], the
        mean MoE aux) over ``batch`` = {tokens [B, St][, vision_embeds [B,
        n_vision, d]]} (S = n_vision + St)."""
        h = _embed_inputs(params, batch)
        auxs = []
        for lp in unstack(params["layers"], L):
            h, aux = layer_train(h, lp)
            auxs.append(aux)
        h = apply_norm(h, params["final_norm"], cfg.norm)
        aux = torch.stack(auxs).mean() if is_moe else torch.zeros((), device=h.device)
        return h, _head(params), aux

    def train_loss(params, batch):
        """(loss + MOE_AUX_COEF · mean aux, {loss, moe_aux, tokens}) over
        ``batch`` = {tokens, targets [B, S], loss_mask [B, S][,
        vision_embeds]}."""
        return lm_loss(*train_hidden(params, batch), batch, cfg.vocab, Vp, loss_chunk)

    if dcfg is not None and dcfg.mesh is not None:
        # a mesh: the train step runs over its data and model shards
        from .sharded_train import transformer_mesh_loss

        train_loss = transformer_mesh_loss(cfg, dcfg, remat=remat, loss_chunk=loss_chunk)

    # ------------------------------------------------------------- prefill
    def prefill(params, batch, capacity: int | None = None):
        """Returns (last-token logits [B, Vp] f32, filled slab cache).
        ``batch["vision_embeds"]`` [B, n_vision, d], when present, precedes
        the token embeddings; ``lengths`` then count the vision positions."""
        lengths = batch["lengths"].to(torch.int32)
        h = _embed_inputs(params, batch)  # [B, S, d]
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
            h, _ = _ffn_block(
                lp, h, o.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["attn"]["wo"].to(h.dtype)
            )
            # K/V zero-padded to capacity, as jnp.pad does at
            # repro/models/transformer.py:192-196 (the slab is zeros beyond S)
            stack, i = (cache["front"], l) if l < skip else (cache["rest"], l - skip)
            stack["k"][i, :, :S] = k.to(torch.bfloat16)
            stack["v"][i, :, :S] = v.to(torch.bfloat16)
        if "meta" in cache["rest"]:
            # the side-car (FIER codes or Quest pages) covers the whole
            # zero-padded slab, prompt padding rows included, as
            # _assemble_cache builds it
            meta = cache["rest"]["meta"]
            for i in range(L - skip):
                mv = build_metadata(cache["rest"]["k"][i], pol)
                for name in meta.FIELDS:
                    getattr(meta, name)[i].copy_(getattr(mv, name))
        rows = torch.arange(B, device=h.device)
        last = apply_norm(h[rows, lengths.to(torch.int64) - 1], params["final_norm"], cfg.norm)
        return _masked_logits(last, _head(params), cfg.vocab, Vp), cache

    def init_cache(B: int, capacity: int, length: int = 0, *, device=None) -> dict:
        """The batched decode cache of the policy's layout (on the bundle's
        device unless ``device`` is given: ``"meta"`` gives its shapes for
        free).  Paged: one block pool shared by every request (a physical
        block id indexes the same row of every layer's pool) and the
        per-request [B, capacity/bs] block table, all zeros (the null block)
        to start with."""
        plan.validate_capacity(capacity)
        dev = device if device is not None else device_
        if not paged:
            return _slab_cache(B, capacity, length, dev)
        bs = pol.block_size
        n_btab = capacity // bs
        n_blocks = pol.pool_blocks or (B * n_btab + 1)
        pool = lambda n, p: kvpaged.init_paged_pool(
            n, n_blocks, bs, cfg.n_kv_heads, cfg.d_head, p, device=dev
        )
        return {
            "front": pool(skip, None),
            "rest": pool(L - skip, pol if pol.kind != "full" else None),
            "length": torch.full((B,), length, dtype=torch.int32, device=dev),
            "block_table": torch.zeros((B, n_btab), dtype=torch.int32, device=dev),
        }

    def _slab_cache(B: int, capacity: int, length: int = 0, dev=None) -> dict:
        dev = dev if dev is not None else device_
        return {
            "front": kvcache.init_layer_cache(
                skip, B, capacity, cfg.n_kv_heads, cfg.d_head, None, device=dev
            ),
            "rest": kvcache.init_layer_cache(
                L - skip, B, capacity, cfg.n_kv_heads, cfg.d_head,
                pol if pol.kind != "full" else None, device=dev,
            ),
            "length": torch.full((B,), length, dtype=torch.int32, device=dev),
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
        zeros, so the hidden states equal a monolithic prefill's.  On a
        mesh-sharded pool the writes go to the owning shards and the
        logical prefix is gathered back whole (every head) before the
        attention (``kvcache.sharded.ShardedPool``).

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
            h, _ = _ffn_block(
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
                for name in meta.FIELDS:
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
                layer_plan, dcfg if l >= skip else None, block_table=block_table,
            )
            h, _ = _ffn_block(lp, h, o, decode=True)
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
        train_loss=train_loss,
        dcfg=dcfg,
        train_hidden=train_hidden,
        loss_chunk=loss_chunk,
    )


# ---------------------------------------------------------------- head / CE

def _vocab_col_mask(vocab: int, Vp: int, device) -> torch.Tensor:
    # the -1e30 padded-column mask of repro/models/transformer.py:439-440,
    # added in f32 after the head
    col = torch.arange(Vp, device=device)
    return torch.where(
        col < vocab, torch.tensor(0.0, device=device), torch.tensor(-1e30, device=device)
    )


# the f32 transient of a head stored below f32, cast one column chunk at a time
LOGIT_CHUNK_BYTES = 1 << 30


def _masked_logits(h: torch.Tensor, W: torch.Tensor, vocab: int, Vp: int) -> torch.Tensor:
    """f32 logits ``h.f32 @ W.f32`` with the padded columns at −1e30.  An f32
    head multiplies in one product; a bf16 one (bf16 params) is cast over
    column chunks of at most LOGIT_CHUNK_BYTES in f32, each just before its
    product, the last chunk ragged: a whole-matrix f32 copy of command-r's
    tied [12288, 256000] head would be 12.6 GB a step."""
    hf = h.to(torch.float32)
    if W.dtype == torch.float32:
        logits = hf @ W
    else:
        n = max(1, LOGIT_CHUNK_BYTES // (4 * W.shape[0]))
        logits = torch.cat([hf @ W[:, c:c + n].to(torch.float32)
                            for c in range(0, W.shape[1], n)], dim=-1)
    return logits + _vocab_col_mask(vocab, Vp, h.device)


def _ce_chunk(hs, W, col_mask, ts, ms):
    logits = hs.to(torch.float32) @ W + col_mask
    nll = (torch.logsumexp(logits, dim=-1) - logits.gather(-1, ts[..., None])[..., 0]) * ms
    return nll.sum(), ms.sum()


def ce_chunk_size(S: int, chunk: int) -> int:
    """min(chunk, S), halved while it does not divide S."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def chunked_ce(h: torch.Tensor, W: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               vocab: int, Vp: int, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked cross-entropy (the reference's ``_chunked_ce``):
    the f32 logits live one [B, chunk, Vp] slice at a time, padded vocab
    columns at −1e30, and each chunk's logits are recomputed in the backward
    rather than kept (``ce_chunk_size``).  Returns (mean NLL over the mask,
    the mask's sum)."""
    tot, cnt = chunked_ce_sum(h, W, targets, mask, vocab, Vp, chunk)
    return tot / torch.clamp(cnt, min=1.0), cnt


def chunked_ce_sum(h: torch.Tensor, W: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                   vocab: int, Vp: int, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``chunked_ce``'s (NLL summed over the mask, the mask's sum): what a
    data shard contributes to the global loss."""
    S = h.shape[1]
    chunk = ce_chunk_size(S, chunk)
    col_mask = _vocab_col_mask(vocab, Vp, h.device)
    Wf = W.to(torch.float32)
    targets, mask = targets.to(torch.int64), mask.to(torch.float32)
    tot = cnt = torch.zeros((), device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        nll, n = checkpoint(_ce_chunk, h[:, sl], Wf, col_mask, targets[:, sl], mask[:, sl],
                            use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot, cnt


def lm_loss(h: torch.Tensor, W: torch.Tensor, aux: torch.Tensor, batch: dict, vocab: int,
            Vp: int, chunk: int) -> tuple[torch.Tensor, dict]:
    """A bundle's ``train_loss`` from its ``train_hidden``: (mean NLL +
    MOE_AUX_COEF · aux, {loss, moe_aux, tokens})."""
    loss, n_tok = chunked_ce(h, W, batch["targets"], batch["loss_mask"], vocab, Vp, chunk)
    return loss + MOE_AUX_COEF * aux, {"loss": loss, "moe_aux": aux, "tokens": n_tok}
