"""Shared model layers: norms, RoPE, MLPs, flash attention, init.

Port of ``repro.models.layers``.  Compute dtype is bf16, params fp32,
reductions and softmax in f32.  Flash attention is plain PyTorch — blocked
f32 matmuls with an online softmax, and a blockwise backward that
recomputes the probabilities from the saved log-sum-exp
(``torch.autograd.Function``) — and never a library attention kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# --------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, w: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return y.to(x.dtype)


def layer_norm(
    x: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor | None, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """kind: rms | layernorm | nonparametric (OLMo: LN with no learnables)."""
    if kind == "rms":
        return rms_norm(x, p["w"])
    if kind == "layernorm":
        return layer_norm(x, p.get("w"), p.get("b"))
    if kind == "nonparametric":
        return layer_norm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def init_norm(kind: str, d: int, *, n: int | None = None, device="cuda") -> dict:
    """Norm params; ``n`` prepends a stacked layer axis."""
    lead = () if n is None else (n,)
    if kind == "rms":
        return {"w": torch.ones((*lead, d), device=device)}
    if kind == "layernorm":
        return {
            "w": torch.ones((*lead, d), device=device),
            "b": torch.zeros((*lead, d), device=device),
        }
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------- RoPE

def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    """Inverse frequencies in f32, computed by numpy exactly as the reference."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions broadcastable to [..., S] (int)."""
    D = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(D, theta)).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1 = x[..., : D // 2].to(torch.float32)
    xf2 = x[..., D // 2 :].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------- MLPs

def silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1/(1 + exp(−x)) with every op rounded to x's dtype: the bf16
    lowering of ``jax.nn.silu`` that repro/models/layers.py:120 runs (XLA
    rounds the exp, the add, the divide and the product each to bf16).
    ``F.silu`` rounds once and differs in about a third of bf16 outputs."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation x · ½(1 + tanh(√(2/π)(x + 0.044715x³))) that
    ``jax.nn.gelu`` computes by default (repro/models/layers.py:123), op by
    op in x's dtype with both constants rounded to it first, as XLA
    evaluates it.  ``F.gelu`` is the erf form: it differs in about half of
    the bf16 outputs."""
    c, a = torch.tensor([math.sqrt(2.0 / math.pi), 0.044715], device=x.device).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def mlp_apply(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """SwiGLU ('silu': w1/w3 gate) or GeLU ('gelu': single up-proj)."""
    if act == "silu":
        h = silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    elif act == "gelu":
        h = gelu(x @ p["w1"].to(x.dtype))
    else:
        raise ValueError(act)
    return h @ p["w2"].to(x.dtype)


def _normal(gen: torch.Generator, shape, std: float, device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One f32 draw of ``shape`` scaled in place (the bits of ``randn * std``)
    and cast once to ``dtype``: a leaf of bf16 params never exists twice in
    f32."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(std).to(dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str, *, n: int = 1,
             device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """MLP params stacked over ``n`` layers, each leaf cast to ``dtype`` as drawn."""
    p = {
        "w1": _normal(gen, (n, d, ff), d**-0.5, device, dtype),
        "w2": _normal(gen, (n, ff, d), ff**-0.5, device, dtype),
    }
    if act == "silu":
        p["w3"] = _normal(gen, (n, d, ff), d**-0.5, device, dtype)
    return p


def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), d**-0.5, device, dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, n: int = 1,
                device="cuda", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _normal(gen, (n, d_in, d_out), d_in**-0.5, device, dtype)


# ----------------------------------------------------------- flash attention

BLOCK_Q = 512


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_k: int = 512,
    q_offset: int = 0,
    bias_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blocked attention with an online softmax and a blockwise backward
    (the reference's ``flash_attention`` and its custom VJP).

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] (GQA: Hq = rep·Hkv);
    ``q_offset`` is the global position of q[0]; ``bias_mask`` [B, Sk]
    marks valid key slots.  Query blocks of 512 rows, key blocks of
    ``block_k``; a key block entirely above the causal diagonal of a query
    block is skipped in both directions (it would add exact zeros).  The
    backward keeps only (q, k, v, out, lse): memory O(S·block) both ways.
    """
    return _FlashAttention.apply(q, k, v, bias_mask, causal, block_k, q_offset)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_mask, causal, block_k, q_offset):
        out = torch.empty_like(q)
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Sq, k.shape[2], Hq // k.shape[2]), device=q.device)
        for q0 in range(0, Sq, BLOCK_Q):
            q1 = min(q0 + BLOCK_Q, Sq)
            out[:, q0:q1], lse[:, q0:q1] = _flash_block(
                q[:, q0:q1], k, v, causal, block_k, q_offset + q0, bias_mask
            )
        ctx.save_for_backward(q, k, v, out, lse, bias_mask)
        ctx.args = (causal, block_k, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        """``_flash_bwd_impl``: per 512-row query block, dq in full and
        dk/dv rounded to their dtype, summed over the query blocks in f32."""
        q, k, v, out, lse, bias_mask = ctx.saved_tensors
        causal, block_k, q_offset = ctx.args
        Sq = q.shape[1]
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for q0 in range(0, Sq, BLOCK_Q):
            q1 = min(q0 + BLOCK_Q, Sq)
            dq[:, q0:q1], dk_i, dv_i = _flash_bwd_block(
                q[:, q0:q1], k, v, out[:, q0:q1], lse[:, q0:q1], dout[:, q0:q1],
                causal, block_k, q_offset + q0, bias_mask,
            )
            dk += dk_i.to(k.dtype)
            dv += dv_i.to(v.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def _key_mask(B, Sq, q_pos, k0, k1, causal, bias_mask, dev):
    """[B, Sq, k1 − k0] True where query i may read key j of the block."""
    k_pos = torch.arange(k0, k1, device=dev)
    keep = torch.ones((B, Sq, k1 - k0), dtype=torch.bool, device=dev)
    if causal:
        keep = keep & (q_pos[:, None] >= k_pos[None, :])[None]
    if bias_mask is not None:
        keep = keep & bias_mask[:, None, k0:k1]
    return keep


def _flash_block(q, k, v, causal, block_k, q_offset, bias_mask):
    """One query block's forward: (out [B, Sq, Hq, D] in q's dtype, lse
    [B, Sq, Hkv, rep] f32 = m + log(den))."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dev = q.device
    scale = float(1.0 / np.sqrt(D))
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, rep, D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hkv, rep), float("-inf"), device=dev)
    num = torch.zeros((B, Sq, Hkv, rep, D), device=dev)
    den = torch.zeros((B, Sq, Hkv, rep), device=dev)
    last = q_offset + Sq - 1 if causal else Sk - 1
    for k0 in range(0, min(Sk, last + 1), block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.einsum(
            "bqhrd,bkhd->bqhrk", qf, k[:, k0:k1].to(torch.float32)
        )
        keep = _key_mask(B, Sq, q_pos, k0, k1, causal, bias_mask, dev)
        s = s.masked_fill(~keep[:, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): no contribution
        safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
        num = num * alpha[..., None] + torch.einsum(
            "bqhrk,bkhd->bqhrd", p, v[:, k0:k1].to(torch.float32)
        )
        den = den * alpha + p.sum(dim=-1)
        m = m_new
    den = torch.clamp(den, min=1e-30)
    o = num / den[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype), m + torch.log(den)


def _flash_bwd_block(q, k, v, out, lse, dout, causal, block_k, q_offset, bias_mask):
    """``_flash_bwd_one``: recompute p = exp(s − lse) key block by key
    block (masked scores −1e30, so p is exactly 0 there), with the softmax
    backward's diagonal Dterm = Σ_d dout·out.  Returns (dq in q's dtype,
    dk, dv f32 [B, Sk, Hkv, D])."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dev = q.device
    scale = float(1.0 / np.sqrt(D))
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, rep, D)
    dof = dout.to(torch.float32).reshape(B, Sq, Hkv, rep, D)
    dterm = torch.sum(dof * out.to(torch.float32).reshape(B, Sq, Hkv, rep, D), dim=-1)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Sq, Hkv, rep, D), device=dev)
    dk = torch.zeros((B, Sk, Hkv, D), device=dev)
    dv = torch.zeros((B, Sk, Hkv, D), device=dev)
    last = q_offset + Sq - 1 if causal else Sk - 1
    for k0 in range(0, min(Sk, last + 1), block_k):
        k1 = min(k0 + block_k, Sk)
        kf = k[:, k0:k1].to(torch.float32)
        s = torch.einsum("bqhrd,bkhd->bqhrk", qf, kf) * scale
        keep = _key_mask(B, Sq, q_pos, k0, k1, causal, bias_mask, dev)
        s = s.masked_fill(~keep[:, :, None, None, :], -1e30)
        p = torch.exp(s - lse[..., None])  # [B, Sq, Hkv, rep, blk]
        dv[:, k0:k1] = torch.einsum("bqhrk,bqhrd->bkhd", p, dof)
        dp = torch.einsum("bqhrd,bkhd->bqhrk", dof, v[:, k0:k1].to(torch.float32))
        ds = p * (dp - dterm[..., None]) * scale
        dq += torch.einsum("bqhrk,bkhd->bqhrd", ds, kf)
        dk[:, k0:k1] = torch.einsum("bqhrk,bqhrd->bkhd", ds, qf)
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk, dv


def attention_ref(q, k, v, *, causal=True, q_offset=0, bias_mask=None):
    """Dense oracle for ``flash_attention`` (tests only; materialises the
    S×S scores): softmax in f32, fully masked rows give 0."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, rep, D) * float(1.0 / np.sqrt(D))
    s = torch.einsum("bqhrd,bkhd->bqhrk", qf, k.to(torch.float32))
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        cm = q_pos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~cm[None, :, None, None, :], float("-inf"))
    if bias_mask is not None:
        s = s.masked_fill(~bias_mask[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, v.to(torch.float32))
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
