"""Top-k routed MoE FFN (granite-moe 32 experts top-8, qwen3-moe 128 top-8):
the port of ``repro.models.moe``.

The reference is plain jnp with no Pallas kernel, so this is plain PyTorch:
``torch.topk`` for the router, batched matmuls for the experts.

* :func:`moe_apply` (prefill and chunked prefill): capacity-based scatter
  dispatch.  Each (token, k) slot goes to a position in its expert's bucket
  [E, C, d] given by a cumulative count over the token-major [T·k]
  flattening; slots past the capacity C go to the dump row E·C and
  contribute zero.  C counts every one of the T positions it is given,
  prompt padding included, so the port drops exactly the reference's slots.
* :func:`moe_apply_masked` (decode): every expert on every token, weighted
  by the renormalised top-k gates (zero for the others).

The router multiplies in f32 (``x.astype(f32) @ router``); the experts run
in the compute dtype with ``layers.silu``'s per-op rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _normal, init_linear, silu


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, n: int = 1, device="cuda") -> dict:
    """MoE params stacked over ``n`` layers: router [n, d, E] and the
    experts' SwiGLU weights w1/w3 [n, E, d, ff], w2 [n, E, ff, d]."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": init_linear(gen, d, E, n=n, device=device),
        "w1": _normal(gen, (n, E, d, ff), d**-0.5, device),
        "w3": _normal(gen, (n, E, d, ff), d**-0.5, device),
        "w2": _normal(gen, (n, E, ff, d), ff**-0.5, device),
    }


def _route(x: torch.Tensor, p: dict, k: int):
    """f32 router logits [T, E], the top-k experts [T, k] (descending, as
    ``lax.top_k``) and their gates renormalised over the k (f32)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    gvals, eidx = torch.topk(logits, k, dim=-1)
    return logits, eidx, torch.softmax(gvals, dim=-1)


def _aux(logits: torch.Tensor, eidx: torch.Tensor, E: int, k: int) -> torch.Tensor:
    """The Switch-style load-balancing loss E · Σ_e f_e/k · P_e."""
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    f = F.one_hot(eidx.reshape(-1), E).reshape(T, k, E).sum(1).to(torch.float32).mean(0)
    return E * torch.sum(f / k * probs.mean(0))


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert bucket for T tokens (the reference's formula)."""
    return max(int(T * cfg.topk_experts / cfg.n_experts * cfg.capacity_factor + 0.999), 1)


def dispatch_slots(eidx: torch.Tensor, E: int, C: int):
    """Each (token, k) slot's row in the [E·C + 1, d] bucket buffer, in the
    token-major [T·k] order, and whether it was kept: position = the count
    of earlier slots routed to the same expert; past C it goes to the dump
    row E·C."""
    e_flat = eidx.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos < C
    return torch.where(keep, e_flat * C + pos, torch.full_like(e_flat, E * C)), keep


def moe_apply(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] (the caller flattens batch × seq) → (y [T, d] in x's dtype,
    aux scalar f32)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.topk_experts
    C = capacity(T, cfg)
    logits, eidx, gates = _route(x, p, k)
    slot, keep = dispatch_slots(eidx, E, C)

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x.repeat_interleave(k, dim=0)  # dropped slots all land on the dump row
    hb = buf[: E * C].reshape(E, C, d)
    h1 = silu(torch.bmm(hb, p["w1"].to(x.dtype))) * torch.bmm(hb, p["w3"].to(x.dtype))
    ob = torch.bmm(h1, p["w2"].to(x.dtype)).reshape(E * C, d)
    ob = torch.cat([ob, torch.zeros((1, d), dtype=ob.dtype, device=ob.device)])
    y_slots = ob[slot] * keep[:, None].to(ob.dtype)  # dropped → 0
    # gate products and their sum over k in f32, rounded once: XLA fuses the
    # reference's bf16 multiply-and-sum this way on the CPU
    g = gates.to(ob.dtype).to(torch.float32)[..., None]
    y = (y_slots.reshape(T, k, d).to(torch.float32) * g).sum(dim=1)
    return y.to(x.dtype), _aux(logits, eidx, E, k)


def moe_apply_masked(
    x: torch.Tensor, p: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-masked MoE for decode (T ≈ batch): every expert on every
    token.  The reference's three-operand ``einsum("tef,efd,te->td")`` is
    taken as (h1 · gate), rounded to x's dtype, then one contraction over
    (e, f) with f32 accumulation: [T, E·ff] @ [E·ff, d], which reads w2
    once."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.topk_experts
    logits, eidx, gates = _route(x, p, k)
    g_full = (F.one_hot(eidx, E).to(torch.float32) * gates[..., None]).sum(dim=1)  # [T, E]
    w1, w3, w2 = (p[n].to(x.dtype) for n in ("w1", "w3", "w2"))
    h1 = silu(torch.matmul(x, w1)) * torch.matmul(x, w3)  # [E, T, ff]
    h1g = h1.permute(1, 0, 2) * g_full.to(x.dtype)[..., None]  # [T, E, ff]
    y = h1g.reshape(T, -1) @ w2.reshape(-1, d)
    return y.to(x.dtype), _aux(logits, eidx, E, k)


def moe_apply_ep(*args, **kwargs):
    """Expert-parallel dispatch over a device mesh: not ported."""
    raise NotImplementedError(
        "expert-parallel MoE over a mesh is not ported yet (ROADMAP Queue 1 item 10, "
        "its training part)"
    )
