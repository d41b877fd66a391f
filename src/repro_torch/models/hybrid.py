"""Zamba2-style hybrid: a Mamba2 backbone with one weight-shared attention
block — the port of ``repro.models.hybrid``.

Every ``attn_every`` Mamba2 layers the one shared block (a single weight
copy) runs on ``concat(hidden, original embedding)`` (width 2·d_model)
through its attention, while its MLP reads the post-attention hidden
(width d).  Each *application point* keeps its own KV cache (weights shared,
activations not): n_apps = n_layers // attn_every caches
[n_apps, B, capacity, Hkv, D] with the policy's side-car, the model's only
KV caches and exactly where FIER runs.  ``pol.skip_layers`` is ignored:
every application point runs the policy (the first already sits
``attn_every`` layers deep).  ``params["mamba"]`` is stacked
[n_apps, attn_every, ...]; the ``n_layers − n_apps·attn_every`` layers
left over are ``mamba_tail`` (81 = 13·6 + 3 at zamba2-7b).

``train_loss`` runs each application point's Mamba2 layers and the shared
block as one rematerialised unit (the reference's ``super_fn`` under
``jax.checkpoint``); the shared block's gradient is the sum over its
application points, which autograd forms from its one weight copy.

The cache is {"mamba": {conv, ssm} [n_apps, E, B, ...], "attn": {k, v[,
meta]}, "length", ["mamba_tail"]}, updated in place.  On a mesh
(``DistConfig.seq_axes``) it is placed by ``launch.sharding.cache_shardings``:
the shared block's slabs split over batch × sequence and decode through
``attention._sharded_decode_step``, the Mamba2 states split over batch and
step where they lie (``mamba2.decode_layer``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.placement import at_home, home_params, index_layer, map_leaf
from repro_torch.core.policy import DecodePlan, PolicyConfig, build_metadata
from repro_torch.kvcache import cache as kvcache

from . import attention as attn
from . import mamba2
from .layers import (apply_norm, flash_attention, init_embedding, init_mlp, init_norm, mlp_apply,
                     rms_norm)
from .transformer import (_DTYPES, ModelBundle, _masked_logits, checkpointed, lm_loss,
                          tree_map, unstack)

STACKED = ("mamba", "mamba_tail")  # the params read one layer at a time


def _n_apps(cfg: ModelConfig) -> tuple[int, int]:
    n_apps = cfg.n_layers // cfg.attn_every
    return n_apps, cfg.n_layers - n_apps * cfg.attn_every


def init_shared_block(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    one = lambda tree: tree_map(lambda a: a[0], tree)  # the single weight copy, unstacked
    return {
        "norm1": init_norm(cfg.norm, 2 * cfg.d_model, device=device),
        "attn": one(attn.init_attention(gen, cfg, d_in=2 * cfg.d_model, device=device)),
        "norm2": init_norm(cfg.norm, cfg.d_model, device=device),
        "mlp": one(init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, device=device)),
    }


def build(cfg: ModelConfig, pol: PolicyConfig | None = None, dcfg: attn.DistConfig | None = None,
          *, device="cuda", remat: bool = True, loss_chunk: int = 1024) -> ModelBundle:
    """``dcfg``: with ``seq_axes`` the shared block decodes sequence-sharded
    on a cache placed by ``launch.sharding.cache_shardings``
    (``attention.decode_self_attention``), and the Mamba2 states step where
    they lie (``mamba2.decode_layer``); prefill and decode read placed
    params and a placed batch at home (``core.placement.at_home``)."""
    device = torch.device(device)
    pol = pol or PolicyConfig(kind="full")
    plan = DecodePlan.build(pol)
    Vp = padded_vocab(cfg)
    cdt, pdt = _DTYPES[cfg.compute_dtype], _DTYPES[cfg.param_dtype]
    n_apps, tail = _n_apps(cfg)
    E = cfg.attn_every
    H, D = cfg.n_heads, cfg.d_head

    def init(gen: torch.Generator | int) -> dict:
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        main = mamba2.init_mamba_block(gen, cfg, n=n_apps * E, device=device)
        params = {
            "embed": init_embedding(gen, Vp, cfg.d_model, device=device),
            "mamba": tree_map(lambda a: a.reshape(n_apps, E, *a.shape[1:]), main),
            "shared": init_shared_block(gen, cfg, device=device),
            "final_norm": torch.ones((cfg.d_model,), device=device),
        }
        if tail:
            params["mamba_tail"] = mamba2.init_mamba_block(gen, cfg, n=tail, device=device)
        return tree_map(lambda a: a.to(pdt), params)

    def compute_params(params: dict) -> dict:
        """The Mamba2 projections and the shared block's matmul weights in
        the compute dtype; the conv, SSD and norm leaves stay f32 (decode
        reads ``conv_w`` in f32)."""
        sp = params["shared"]
        out = dict(params, mamba=mamba2.compute_block(params["mamba"], cdt), shared=dict(
            sp, attn={k: (v.to(cdt) if k.startswith("w") else v) for k, v in sp["attn"].items()},
            mlp=tree_map(lambda a: a.to(cdt), sp["mlp"])))
        if tail:
            out["mamba_tail"] = mamba2.compute_block(params["mamba_tail"], cdt)
        return out

    def _ffn(sp, h, o):
        """h + o, then the shared block's MLP on it; the norm reads the f32
        residual sum, as the transformer's ``_ffn_block`` mirrors XLA's
        compiled layer."""
        r = h.to(torch.float32) + o.to(torch.float32)
        xn = apply_norm(r, sp["norm2"], cfg.norm).to(cdt)
        return r.to(cdt) + mlp_apply(xn, sp["mlp"], cfg.act)

    # ---------------------------------------------------------------- train
    def _super_train(h, x0, lps, sp):
        """One application point: its attn_every Mamba2 layers, then the
        shared block (attention on concat(h, x0), MLP on the hidden)."""
        for lp in lps:
            h = mamba2.mamba_block_train(h, lp, cfg)
        xn = apply_norm(torch.cat([h, x0], dim=-1), sp["norm1"], cfg.norm)
        return _ffn(sp, h, attn.attention_train(sp["attn"], xn, cfg))

    super_train = checkpointed(_super_train, remat)
    tail_train = checkpointed(lambda h, lp: mamba2.mamba_block_train(h, lp, cfg), False)

    def train_hidden(params, batch):
        """(the final-normed hidden states, the tied head, aux 0) over
        {tokens}."""
        x0 = h = params["embed"][batch["tokens"]].to(cdt)
        for app in unstack(params["mamba"], n_apps):
            h = super_train(h, x0, unstack(app, E), params["shared"])
        if tail:
            for lp in unstack(params["mamba_tail"], tail):
                h = tail_train(h, lp)
        h = rms_norm(h, params["final_norm"])
        return h, params["embed"].T, torch.zeros((), device=h.device)

    def train_loss(params, batch):
        """(loss, {loss, moe_aux: 0, tokens}) over {tokens, targets, loss_mask}."""
        return lm_loss(*train_hidden(params, batch), batch, cfg.vocab, Vp, loss_chunk)

    # -------------------------------------------------------------- prefill
    def prefill(params, batch, capacity: int | None = None):
        """Returns (last-token logits [B, Vp] f32, the cache with each
        application point's K/V zero-padded to ``capacity`` and its side-car
        over the whole padded slab), on the bundle's device."""
        batch = {k: at_home(v, device) for k, v in batch.items()}
        params = home_params(params, device, STACKED)
        lengths = batch["lengths"].to(torch.int32)
        h = params["embed"][batch["tokens"]].to(cdt)
        B, S, _ = h.shape
        cap = capacity if capacity is not None else S
        x0 = h
        valid = kvcache.valid_mask(S, lengths)
        cache = init_cache(B, cap, 0)
        cache["length"] = lengths.clone()
        ms, ac, sp = cache["mamba"], cache["attn"], params["shared"]
        for a in range(n_apps):
            for e in range(E):
                h, st = mamba2.mamba_prefill_step(
                    h, tree_map(lambda x: at_home(x, device, (a, e)), params["mamba"]), cfg,
                    lengths, valid)
                ms["conv"][a, e], ms["ssm"][a, e] = st["conv"], st["ssm"]
            xn = apply_norm(torch.cat([h, x0], dim=-1), sp["norm1"], cfg.norm)
            q, k, v = attn.qkv_proj(sp["attn"], xn, cfg, positions=None)
            o = flash_attention(q, k, v, causal=True, bias_mask=valid)
            h = _ffn(sp, h, o.reshape(B, S, H * D) @ sp["attn"]["wo"].to(h.dtype))
            ac["k"][a, :, :S] = k.to(torch.bfloat16)
            ac["v"][a, :, :S] = v.to(torch.bfloat16)
        if "meta" in ac:
            meta = ac["meta"]
            for a in range(n_apps):
                mv = build_metadata(ac["k"][a], pol)
                for name in meta.FIELDS:
                    getattr(meta, name)[a].copy_(getattr(mv, name))
        if tail:
            mt = cache["mamba_tail"]
            for t in range(tail):
                h, st = mamba2.mamba_prefill_step(
                    h, tree_map(lambda x: at_home(x, device, t), params["mamba_tail"]), cfg,
                    lengths, valid)
                mt["conv"][t], mt["ssm"][t] = st["conv"], st["ssm"]
        rows = torch.arange(B, device=h.device)
        last = rms_norm(h[rows, lengths.to(torch.int64) - 1], params["final_norm"])
        return _masked_logits(last, params["embed"].T, cfg.vocab, Vp), cache

    # --------------------------------------------------------------- decode
    def _mamba_steps(h, p, st, idx):
        for i in idx:
            lp = tree_map(lambda x: at_home(x, device, i), p)
            h = mamba2.decode_layer(h, lp, index_layer(st["conv"], i),
                                    index_layer(st["ssm"], i), cfg)
        return h

    def decode_step(params, token, cache):
        """One token per sequence; the cache is updated in place (a placed
        one piece by piece where it lies) and returned with ``length + 1``."""
        length = at_home(cache["length"], device)
        params = home_params(params, device, STACKED)
        x0 = h = params["embed"][at_home(token, device)][:, None, :].to(cdt)
        sp = params["shared"]
        for a in range(n_apps):
            h = _mamba_steps(h, params["mamba"], cache["mamba"], [(a, e) for e in range(E)])
            xn = apply_norm(torch.cat([h, x0], dim=-1), sp["norm1"], cfg.norm)
            o = attn.decode_self_attention(
                sp["attn"], xn, kvcache.layer_cache(cache["attn"], a), length, cfg, plan, dcfg)
            h = _ffn(sp, h, o)
        if tail:
            h = _mamba_steps(h, params["mamba_tail"], cache["mamba_tail"], range(tail))
        h = rms_norm(h, params["final_norm"])[:, 0]
        logits = _masked_logits(h, params["embed"].T, cfg.vocab, Vp)
        return logits, dict(cache, length=map_leaf(lambda n: n + 1, cache["length"]))

    def init_cache(B: int, capacity: int, length: int = 0, *, device=None) -> dict:
        plan.validate_capacity(capacity)
        dev = device if device is not None else bundle.device
        cache = {
            "mamba": mamba2.init_mamba_state((n_apps, E), B, cfg, dev),
            "attn": kvcache.init_layer_cache(
                n_apps, B, capacity, cfg.n_kv_heads, D, pol if pol.kind != "full" else None,
                device=dev,
            ),
            "length": torch.full((B,), length, dtype=torch.int32, device=dev),
        }
        if tail:
            cache["mamba_tail"] = mamba2.init_mamba_state((tail,), B, cfg, dev)
        return cache

    bundle = ModelBundle(
        cfg=cfg, init=init, prefill=prefill, decode_step=decode_step, init_cache=init_cache,
        param_count=cfg.param_count, compute_params=compute_params, device=device,
        policy=pol, plan=plan, train_loss=train_loss, dcfg=dcfg,
        train_hidden=train_hidden, loss_chunk=loss_chunk,
    )
    return bundle
