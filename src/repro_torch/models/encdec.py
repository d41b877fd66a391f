"""Whisper-style encoder-decoder: the port of ``repro.models.encdec``.

The audio conv frontend is a stub: prefill takes precomputed frame
embeddings ``batch["frames"]`` [B, enc_ctx, d_model] (through
``Engine.insert`` / ``Engine.generate``'s ``extras``).  The encoder is
bidirectional self-attention with sinusoidal positions; the decoder is
causal self-attention (cached, FIER-eligible past the skip layers, split
into ``front`` and ``rest`` as the transformer's), cross-attention to the
encoder output (its K/V computed once at prefill and kept full: 1500
frames, below any useful retrieval budget) and a GeLU MLP.  Decoder
positions are learned; the table has ``max_positions`` rows (the config's
``max_target_positions`` by default) and decode clips the position to its
last row.  Prefill's attention is the plain-torch ``flash_attention``
(non-causal against the encoder output); decode's cross-attention is
``full_attention_decode`` over ``cross_k`` / ``cross_v``.

``train_loss`` encodes the frames, runs the decoder over the whole target
sequence (causal self-attention, cross-attention to the encoder output
through ``attention_train``'s ``kv_x``), each encoder and decoder layer
rematerialised in the backward when ``remat``, then the chunked
cross-entropy (chunk 512) against the tied embedding.

The cache is {"front", "rest" (as the transformer's), "cross_k", "cross_v"
[L, B, enc_ctx, Hkv, D] bf16, "length"}, updated in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.policy import DecodePlan, PolicyConfig, build_metadata
from repro_torch.core.retrieval import full_attention_decode
from repro_torch.kvcache import cache as kvcache

from . import attention as attn
from .layers import apply_norm, flash_attention, init_embedding, init_mlp, init_norm, mlp_apply
from .transformer import (_DTYPES, ModelBundle, _layer_cache, _layer_params, _masked_logits,
                          checkpointed, lm_loss, tree_map, unstack)


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig, *, n: int, device="cuda") -> dict:
    d = cfg.d_model
    return {
        "norm1": init_norm(cfg.norm, d, n=n, device=device),
        "attn": attn.init_attention(gen, cfg, n=n, device=device),
        "norm2": init_norm(cfg.norm, d, n=n, device=device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, n=n, device=device),
    }


def init_dec_layer(gen: torch.Generator, cfg: ModelConfig, *, n: int, device="cuda") -> dict:
    d = cfg.d_model
    return {
        "norm1": init_norm(cfg.norm, d, n=n, device=device),
        "self_attn": attn.init_attention(gen, cfg, n=n, device=device),
        "norm_x": init_norm(cfg.norm, d, n=n, device=device),
        "cross_attn": attn.init_attention(gen, cfg, n=n, device=device),
        "norm2": init_norm(cfg.norm, d, n=n, device=device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, n=n, device=device),
    }


def _cross_attention_decode(p, x, k_cross, v_cross, cfg: ModelConfig):
    """q from x [B, 1, d] against the fixed cross K/V [B, Senc, Hkv, D] (full)."""
    B = x.shape[0]
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    o = full_attention_decode(q.reshape(B, cfg.n_heads, cfg.d_head), k_cross, v_cross, length=None)
    return o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def _residual(h, a):
    """h + a with the f32 sum kept for the norm that reads it (the
    transformer's ``_ffn_block`` convention): (rounded sum, f32 sum)."""
    r = h.to(torch.float32) + a.to(torch.float32)
    return r.to(h.dtype), r


def build(cfg: ModelConfig, pol: PolicyConfig | None = None, *, device="cuda",
          max_positions: int | None = None, remat: bool = True,
          loss_chunk: int = 512) -> ModelBundle:
    device = torch.device(device)
    pol = pol or PolicyConfig(kind="full")
    plan = DecodePlan.build(pol)
    plan_full = DecodePlan.build(PolicyConfig(kind="full", skip_layers=0))
    Vp = padded_vocab(cfg)
    cdt, pdt = _DTYPES[cfg.compute_dtype], _DTYPES[cfg.param_dtype]
    L = cfg.n_layers
    skip = min(pol.skip_layers if pol.kind != "full" else 0, L)
    max_pos = max_positions or cfg.max_target_positions
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def init(gen: torch.Generator | int) -> dict:
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        params = {
            "embed": init_embedding(gen, Vp, cfg.d_model, device=device),
            "pos_dec": torch.randn((max_pos, cfg.d_model), generator=gen, device=device) * 0.01,
            "enc_layers": init_enc_layer(gen, cfg, n=cfg.n_enc_layers, device=device),
            "enc_norm": init_norm(cfg.norm, cfg.d_model, device=device),
            "dec_layers": init_dec_layer(gen, cfg, n=L, device=device),
            "dec_norm": init_norm(cfg.norm, cfg.d_model, device=device),
        }
        return tree_map(lambda a: a.to(pdt), params)

    def compute_params(params: dict) -> dict:
        """One compute-dtype copy of every stacked layer matmul weight (the
        biases, norms, embedding and position table stay as they are)."""
        cast = lambda a: a.to(cdt) if a.dim() >= 3 else a
        return dict(params, enc_layers=tree_map(cast, params["enc_layers"]),
                    dec_layers=tree_map(cast, params["dec_layers"]))

    # --------------------------------------------------------------- encode
    def _enc_layer(h, lp):
        a = attn.attention_train(lp["attn"], apply_norm(h, lp["norm1"], cfg.norm), cfg,
                                 causal=False)
        h, r = _residual(h, a)
        return h + mlp_apply(apply_norm(r, lp["norm2"], cfg.norm).to(cdt), lp["mlp"], cfg.act)

    enc_layer_train = checkpointed(_enc_layer, remat)

    def encode(params, frames, *, train: bool = False):
        """frames [B, Senc, d] → the encoder output [B, Senc, d] (bf16);
        ``train`` rematerialises each layer when the bundle remats."""
        pos = torch.from_numpy(sinusoids(frames.shape[1], cfg.d_model)).to(frames.device, cdt)
        h = frames.to(cdt) + pos
        layer = enc_layer_train if train else _enc_layer
        for lp in unstack(params["enc_layers"], cfg.n_enc_layers):
            h = layer(h, lp)
        return apply_norm(h, params["enc_norm"], cfg.norm)

    def _dec_embed(params, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return (params["embed"][tokens] + params["pos_dec"][pos][None]).to(cdt)

    # ---------------------------------------------------------------- train
    def _dec_layer(h, lp, enc):
        a = attn.attention_train(lp["self_attn"], apply_norm(h, lp["norm1"], cfg.norm), cfg)
        h, r = _residual(h, a)
        x = attn.attention_train(lp["cross_attn"], apply_norm(r, lp["norm_x"], cfg.norm).to(cdt),
                                 cfg, causal=False, kv_x=enc)
        h, r = _residual(h, x)
        return h + mlp_apply(apply_norm(r, lp["norm2"], cfg.norm).to(cdt), lp["mlp"], cfg.act)

    dec_layer_train = checkpointed(_dec_layer, remat)

    def train_hidden(params, batch):
        """(the final-normed decoder states, the tied head, aux 0) over
        {frames [B, enc_ctx, d], tokens}."""
        enc = encode(params, batch["frames"], train=True)
        h = _dec_embed(params, batch["tokens"])
        for lp in unstack(params["dec_layers"], L):
            h = dec_layer_train(h, lp, enc)
        h = apply_norm(h, params["dec_norm"], cfg.norm)
        return h, params["embed"].T, torch.zeros((), device=h.device)

    def train_loss(params, batch):
        """(loss, {loss, moe_aux: 0, tokens}) over {frames, tokens, targets,
        loss_mask}."""
        return lm_loss(*train_hidden(params, batch), batch, cfg.vocab, Vp, loss_chunk)

    # -------------------------------------------------------------- prefill
    def prefill(params, batch, capacity: int | None = None):
        """Returns (last-token logits [B, Vp] f32, the filled cache).
        ``batch["frames"]`` [B, enc_ctx, d] are the audio frame embeddings."""
        lengths = batch["lengths"].to(torch.int32)
        enc = encode(params, batch["frames"])
        h = _dec_embed(params, batch["tokens"])
        B, S, _ = h.shape
        cap = capacity if capacity is not None else S
        valid = kvcache.valid_mask(S, lengths)
        Senc = enc.shape[1]
        cache = init_cache(B, cap, 0)
        cache["length"] = lengths.clone()
        for l in range(L):
            lp = _layer_params(params["dec_layers"], l)
            xn = apply_norm(h, lp["norm1"], cfg.norm)
            q, k, v = attn.qkv_proj(lp["self_attn"], xn, cfg, positions=None)
            o = flash_attention(q, k, v, causal=True, bias_mask=valid)
            h, r = _residual(h, o.reshape(B, S, -1) @ lp["self_attn"]["wo"].to(h.dtype))
            # cross attention, and the cross K/V it keeps for decode
            xa = lp["cross_attn"]
            xq = apply_norm(r, lp["norm_x"], cfg.norm).to(cdt)
            kc = (enc @ xa["wk"].to(cdt)).reshape(B, Senc, Hkv, D)
            vc = (enc @ xa["wv"].to(cdt)).reshape(B, Senc, Hkv, D)
            qc = (xq @ xa["wq"].to(cdt)).reshape(B, S, H, D)
            xo = flash_attention(qc, kc, vc, causal=False)
            h, r = _residual(h, xo.reshape(B, S, -1) @ xa["wo"].to(h.dtype))
            h = h + mlp_apply(apply_norm(r, lp["norm2"], cfg.norm).to(cdt), lp["mlp"], cfg.act)
            stack, i = (cache["front"], l) if l < skip else (cache["rest"], l - skip)
            stack["k"][i, :, :S] = k.to(torch.bfloat16)
            stack["v"][i, :, :S] = v.to(torch.bfloat16)
            cache["cross_k"][l] = kc.to(torch.bfloat16)
            cache["cross_v"][l] = vc.to(torch.bfloat16)
        if "meta" in cache["rest"]:
            meta = cache["rest"]["meta"]
            for i in range(L - skip):
                mv = build_metadata(cache["rest"]["k"][i], pol)
                for name in meta.FIELDS:
                    getattr(meta, name)[i].copy_(getattr(mv, name))
        rows = torch.arange(B, device=h.device)
        last = apply_norm(h[rows, lengths.to(torch.int64) - 1], params["dec_norm"], cfg.norm)
        return _masked_logits(last, params["embed"].T, cfg.vocab, Vp), cache

    # --------------------------------------------------------------- decode
    def decode_step(params, token, cache):
        """One token per sequence; the cache is updated in place and returned
        with ``length + 1``."""
        length = cache["length"]
        pos = torch.clamp(length.to(torch.int64), 0, max_pos - 1)
        h = (params["embed"][token] + params["pos_dec"][pos])[:, None, :].to(cdt)
        for l in range(L):
            lp = _layer_params(params["dec_layers"], l)
            if l < skip:
                lc, layer_plan = _layer_cache(cache["front"], l), plan_full
            else:
                lc, layer_plan = _layer_cache(cache["rest"], l - skip), plan
            o = attn.decode_self_attention(
                lp["self_attn"], apply_norm(h, lp["norm1"], cfg.norm), lc, length, cfg, layer_plan)
            h, r = _residual(h, o)
            x = _cross_attention_decode(lp["cross_attn"],
                                        apply_norm(r, lp["norm_x"], cfg.norm).to(cdt),
                                        cache["cross_k"][l], cache["cross_v"][l], cfg)
            h, r = _residual(h, x)
            h = h + mlp_apply(apply_norm(r, lp["norm2"], cfg.norm).to(cdt), lp["mlp"], cfg.act)
        h = apply_norm(h, params["dec_norm"], cfg.norm)[:, 0]
        logits = _masked_logits(h, params["embed"].T, cfg.vocab, Vp)
        return logits, dict(cache, length=length + 1)

    def init_cache(B: int, capacity: int, length: int = 0, *, device=None) -> dict:
        plan.validate_capacity(capacity)
        dev = device if device is not None else bundle.device
        cross = lambda: torch.zeros((L, B, cfg.enc_ctx, Hkv, D), dtype=torch.bfloat16, device=dev)
        return {
            "front": kvcache.init_layer_cache(skip, B, capacity, Hkv, D, None, device=dev),
            "rest": kvcache.init_layer_cache(
                L - skip, B, capacity, Hkv, D, pol if pol.kind != "full" else None, device=dev),
            "cross_k": cross(),
            "cross_v": cross(),
            "length": torch.full((B,), length, dtype=torch.int32, device=dev),
        }

    bundle = ModelBundle(
        cfg=cfg, init=init, prefill=prefill, decode_step=decode_step, init_cache=init_cache,
        param_count=cfg.param_count, compute_params=compute_params, device=device,
        policy=pol, plan=plan, train_loss=train_loss,
        train_hidden=train_hidden, loss_chunk=loss_chunk,
    )
    return bundle
