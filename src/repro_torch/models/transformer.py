"""Decoder-only dense LM with FIER-integrated decode (port of
``repro.models.transformer`` for ``family='dense'``).

* Layer params are stacked along a leading L axis; depth is a Python loop.
* Prefill runs blocked flash attention over the prompt, zero-pads each
  layer's K/V to ``capacity`` and quantizes the whole padded slab of every
  layer past ``skip_layers`` into the FIER side-car.
* Decode splits the stack at ``skip``: the front layers attend densely
  (the paper's skip layers), the rest through the policy's ``DecodePlan``.
* The vocab is padded to a multiple of 256; padded columns get −1e30.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.policy import DecodePlan, PolicyConfig, build_metadata
from repro_torch.kvcache import cache as kvcache

from . import attention as attn
from .layers import apply_norm, flash_attention, init_embedding, init_mlp, init_norm, mlp_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable               # (generator | seed) -> params
    prefill: Callable            # (params, batch, capacity) -> (logits [B,Vp], cache)
    decode_step: Callable        # (params, token [B], cache) -> (logits, cache)
    init_cache: Callable         # (B, capacity, length) -> cache
    param_count: Callable
    compute_params: Callable     # params -> params with bf16 matmul weights
    device: torch.device
    policy: PolicyConfig | None = None
    plan: DecodePlan | None = None


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
    plan_full = DecodePlan.build(PolicyConfig(kind="full", skip_layers=0))
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
        """Returns (last-token logits [B, Vp] f32, filled cache)."""
        toks = batch["tokens"]
        lengths = batch["lengths"].to(torch.int32)
        h = params["embed"][toks].to(cdt)  # [B, S, d]
        B, S, _ = h.shape
        cap = capacity if capacity is not None else S
        valid = kvcache.valid_mask(S, lengths)
        cache = init_cache(B, cap, 0)
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
        plan.validate_capacity(capacity)
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

    # -------------------------------------------------------------- decode
    def decode_step(params, token, cache):
        """One token per sequence; the cache is updated in place and
        returned with ``length + 1``."""
        length = cache["length"]
        h = params["embed"][token][:, None, :].to(cdt)
        for l in range(L):
            lp = _layer_params(params["layers"], l)
            if l < skip:
                lc, layer_plan = _layer_cache(cache["front"], l), plan_full
            else:
                lc, layer_plan = _layer_cache(cache["rest"], l - skip), plan
            o = attn.decode_self_attention(
                lp["attn"], apply_norm(h, lp["norm1"], cfg.norm), lc, length, cfg,
                layer_plan,
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
