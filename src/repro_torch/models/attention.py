"""GQA attention block: projections and the slab decode step.

Port of ``repro.models.attention`` (``init_attention``, ``qkv_proj``, the
slab single-device branch of ``decode_self_attention``).  The decode step
appends the new token's K/V and refreshes its side-car group in place,
then dispatches attention through ``repro_torch.core.policy``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import policy as core_policy
from repro_torch.core.policy import CacheView, DecodePlan
from repro_torch.kvcache import cache as kvcache

from .layers import apply_rope, init_linear


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, n: int = 1,
                   device="cuda") -> dict:
    """Attention params stacked over ``n`` layers (fp32)."""
    d, Dh = cfg.d_model, cfg.d_head
    p = {
        "wq": init_linear(gen, d, cfg.n_heads * Dh, n=n, device=device),
        "wk": init_linear(gen, d, cfg.n_kv_heads * Dh, n=n, device=device),
        "wv": init_linear(gen, d, cfg.n_kv_heads * Dh, n=n, device=device),
        "wo": init_linear(gen, cfg.n_heads * Dh, d, n=n, device=device),
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


def decode_self_attention(
    p: dict,
    x: torch.Tensor,
    layer_cache: dict,
    length: torch.Tensor,
    cfg: ModelConfig,
    plan: DecodePlan,
) -> torch.Tensor:
    """One-token decode self-attention on a slab cache.

    x: [B, 1, d]; layer_cache: {k, v[, meta]} of one layer (views into the
    stacked cache, updated in place); length: [B] current lengths (the new
    token is written at ``length``).  Returns out [B, 1, d].
    """
    B = x.shape[0]
    q, k_new, v_new = qkv_proj(p, x, cfg, positions=length[:, None])
    qh = q.reshape(B, cfg.n_heads, cfg.d_head)
    k_slab, v_slab = kvcache.append_kv(
        layer_cache["k"], layer_cache["v"], k_new, v_new, length
    )
    meta = layer_cache.get("meta")
    if meta is not None:
        meta = kvcache.append_token_metadata(meta, k_slab, length, plan.policy)
    view = CacheView.slab(k_slab, v_slab, meta, length + 1)
    out = core_policy.decode_attention(qh, view, plan)
    return out.reshape(B, 1, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)
