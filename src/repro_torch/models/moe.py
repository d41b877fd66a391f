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
* :func:`moe_apply_ep` (training on a mesh with ``DistConfig.ep_axis``):
  expert parallelism over token shards × expert shards, capacity per
  token shard.

The router multiplies in f32 (``x.astype(f32) @ router``); the experts run
in the compute dtype with ``layers.silu``'s per-op rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as dist
from repro_torch.core.placement import as_sharded, axis_coords

from .layers import _normal, init_linear, silu


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, n: int = 1, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
    """MoE params stacked over ``n`` layers: router [n, d, E] and the
    experts' SwiGLU weights w1/w3 [n, E, d, ff], w2 [n, E, ff, d], each
    leaf cast to ``dtype`` as drawn."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": init_linear(gen, d, E, n=n, device=device, dtype=dtype),
        "w1": _normal(gen, (n, E, d, ff), d**-0.5, device, dtype),
        "w3": _normal(gen, (n, E, d, ff), d**-0.5, device, dtype),
        "w2": _normal(gen, (n, E, ff, d), ff**-0.5, device, dtype),
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
    x: torch.Tensor, p: dict, cfg: ModelConfig, experts: slice | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-masked MoE for decode (T ≈ batch): every expert on every
    token.  The reference's three-operand ``einsum("tef,efd,te->td")`` is
    taken as (h1 · gate), rounded to x's dtype, then one contraction over
    (e, f) with f32 accumulation: [T, E·ff] @ [E·ff, d], which reads w2
    once.  ``experts`` (an expert shard's range; ``p``'s w1/w3/w2 then
    hold those experts only) gives that shard's partial output, routed
    over every expert: the expert shards' partials sum to the whole."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.topk_experts
    logits, eidx, gates = _route(x, p, k)
    g_full = (F.one_hot(eidx, E).to(torch.float32) * gates[..., None]).sum(dim=1)  # [T, E]
    if experts is not None:
        g_full = g_full[:, experts]
    w1, w3, w2 = (p[n].to(x.dtype) for n in ("w1", "w3", "w2"))
    h1 = silu(torch.matmul(x, w1)) * torch.matmul(x, w3)  # [E, T, ff]
    h1g = h1.permute(1, 0, 2) * g_full.to(x.dtype)[..., None]  # [T, E, ff]
    y = h1g.reshape(T, -1) @ w2.reshape(-1, d)
    return y.to(x.dtype), _aux(logits, eidx, E, k)


def moe_apply_ep(
    x,
    p: dict,
    cfg: ModelConfig,
    *,
    mesh,
    token_axes: tuple[str, ...],
    model_axis: str = "model",
):
    """Expert-parallel MoE over token shards (``token_axes``) × expert
    shards (``model_axis``), single-controller (the reference's
    ``shard_map`` body, ``repro/models/moe.py:78-174``).

    ``x``: one [T, d] tensor, split evenly over the token shards, or a list
    of the token shards' [T_loc, d] tensors in order over ``token_axes``.
    ``p``: router [d, E], w1/w3 [E, d, ff], w2 [E, ff, d] — plain tensors or
    a mesh's ``core.placement.Sharded`` leaves (experts over
    ``model_axis``).  Expert pieces FSDP-stored over other axes are always
    gathered inside the body (where the reference gathers the axes its
    ``fsdp_axes`` names).  Each (token, expert) shard, on its mesh
    device, holds E / n_model experts, sizes its capacity C from its
    *local* token count, dispatches as a scatter of token indices and a
    gather, runs its experts, and combines unrolled over k; then a psum
    over the expert shards gives each token shard its output, and the aux
    loss is the pmean over every shard of the local Switch estimates.
    Returns (y like ``x`` in x's dtype, each token shard's on the device of
    its first expert shard; aux f32).  Gradients flow through the
    collectives (``core/distributed.py``)."""
    E, k = cfg.n_experts, cfg.topk_experts
    n_model = mesh.shape.get(model_axis, 1)
    if E % n_model:
        raise ValueError(f"{E} experts do not divide over {n_model} expert shards")
    E_loc = E // n_model
    tok = [a for a in token_axes if a in mesh.shape]
    n_tok = math.prod(mesh.shape[a] for a in tok)
    whole = isinstance(x, torch.Tensor)
    xs = list(x.chunk(n_tok, dim=0)) if whole else list(x)
    if len(xs) != n_tok:
        raise ValueError(f"{len(xs)} token shards for a mesh of {n_tok}")
    ys, auxs = [], []
    for t, xt in enumerate(xs):
        parts = []
        for m in range(n_model):
            coords = dict(axis_coords(mesh, tok, t), **({model_axis: m} if model_axis in mesh.shape
                                                        else {}))
            dev = mesh.device_at(coords)
            # expert shard m's block of each expert-major weight, every other
            # split dim gathered whole (FSDP storage, gathered in the body)
            w1, w3, w2 = (as_sharded(p[n], mesh).view(coords, {0: (model_axis,)}, dev)
                          for n in ("w1", "w3", "w2"))
            router = as_sharded(p["router"], mesh).view(coords, {}, dev)
            xl = xt.to(dev)
            T_loc, d = xl.shape
            C = capacity(T_loc, cfg)
            logits, eidx, gates = _route(xl, {"router": router}, k)
            e_flat = eidx.reshape(-1)
            e_rel = e_flat - m * E_loc
            local = (e_rel >= 0) & (e_rel < E_loc)
            e_loc = torch.where(local, e_rel, torch.full_like(e_rel, E_loc))
            onehot = F.one_hot(e_loc, E_loc + 1)
            pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_loc[:, None])[:, 0]
            keep = local & (pos < C)
            slot = torch.where(keep, e_loc * C + pos, torch.full_like(e_loc, E_loc * C))
            # dispatch as a scatter of token INDICES + one gather; empty slots
            # point at a zero row past the tokens (kept slots are unique, only
            # the dump row E_loc·C takes several writes, and it is never read)
            slot_tok = torch.full((E_loc * C + 1,), T_loc, dtype=torch.int64, device=dev)
            slot_tok[slot] = torch.arange(e_flat.shape[0], device=dev) // k
            xp = torch.cat([xl, torch.zeros((1, d), dtype=xl.dtype, device=dev)])
            hb = xp[slot_tok[: E_loc * C]].reshape(E_loc, C, d)
            h1 = silu(torch.bmm(hb, w1.to(xl.dtype))) * torch.bmm(hb, w3.to(xl.dtype))
            ob = torch.bmm(h1, w2.to(xl.dtype)).reshape(-1, d)
            ob = torch.cat([ob, torch.zeros((1, d), dtype=ob.dtype, device=dev)])
            # combine unrolled over k; the gate products and their sum in f32,
            # rounded once after the psum, as moe_apply rounds its f32 sum
            # (for f32 x this is the reference's combine)
            slot_t = slot.reshape(T_loc, k)
            gk = gates.to(ob.dtype).to(torch.float32)
            y_part = sum(ob[slot_t[:, j]].to(torch.float32) * gk[:, j, None] for j in range(k))
            parts.append(y_part)
            auxs.append(_aux(logits, eidx, E, k))
        ys.append(dist.psum(parts)[0].to(xt.dtype))
    aux = dist.pmean(auxs)[0]
    return (torch.cat([y.to(ys[0].device) for y in ys]) if whole else ys), aux
