"""KV eviction baselines: StreamingLLM, H2O, TOVA, SnapKV.  Port of
``repro.core.eviction``; plain PyTorch.

These *permanently drop* tokens (the failure mode FIER fixes — dropped
tokens cannot be recalled).  Each is an alive-mask over the cache slab plus
per-policy state, updated once per decode step.  Ties in ``argmin`` and
top-k go to the lower position, as ``jnp.argmin`` and ``lax.top_k`` break
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .retrieval import NEG_INF, _inv_sqrt


class EvictionState(NamedTuple):
    """alive: bool [B, Hkv, S]; acc: f32 [B, Hkv, S] cumulative scores (H2O
    only)."""

    alive: torch.Tensor
    acc: torch.Tensor


def masked_attention_decode(
    q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, alive: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense decode attention restricted to alive tokens, in f32.

    Returns (out [B, Hq, D] in q's dtype, probs [B, Hkv, S]: the attention
    weights averaged over the query group) — the probs feed H2O/TOVA."""
    B, Hq, D = q.shape
    Hkv = K.shape[2]
    qf = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhrd,bshd->bhrs", qf, K.to(torch.float32)) * _inv_sqrt(D, q.device)
    s = s.masked_fill(~alive[:, :, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", p, V.to(torch.float32))
    return out.reshape(B, Hq, D).to(q.dtype), p.mean(dim=2)


def init_state(B: int, Hkv: int, S: int, length: torch.Tensor) -> EvictionState:
    """All prefill tokens alive; acc zeroed."""
    pos = torch.arange(S, dtype=torch.int32, device=length.device)
    alive = (pos[None, :] < length[:, None])[:, None, :].expand(B, Hkv, S).clone()
    return EvictionState(alive, torch.zeros((B, Hkv, S), dtype=torch.float32, device=length.device))


# ---------------------------------------------------------------- StreamingLLM
def streaming_llm_mask(
    S: int, length: torch.Tensor, budget: int, sink: int = 4
) -> torch.Tensor:
    """sink ∪ recent window of (budget - sink).  → bool [B, S] (head-agnostic)."""
    pos = torch.arange(S, dtype=torch.int32, device=length.device)[None, :]
    ln = length[:, None]
    recent = budget - sink
    is_sink = pos < torch.clamp(ln, max=sink)
    is_recent = (pos >= ln - recent) & (pos < ln)
    return is_sink | is_recent


def streaming_llm_state(
    B: int, Hkv: int, S: int, length: torch.Tensor, budget: int, sink: int = 4
) -> EvictionState:
    m = streaming_llm_mask(S, length, budget, sink)
    alive = m[:, None, :].expand(B, Hkv, S).clone()
    return EvictionState(alive, torch.zeros((B, Hkv, S), dtype=torch.float32, device=length.device))


def _evict_one(alive: torch.Tensor, score: torch.Tensor, budget: int) -> torch.Tensor:
    """Kill the first-minimum-score position of every (b, h) row whose alive
    count exceeds ``budget`` (one token arrives per step → at most one
    eviction)."""
    victim = torch.argmin(score, dim=-1)  # first minimum, as jnp.argmin
    over = alive.sum(dim=-1) > budget
    kill = F.one_hot(victim, score.shape[-1]).to(torch.bool) & over[..., None]
    return alive & ~kill


# ------------------------------------------------------------------------ H2O
def h2o_step(
    state: EvictionState,
    probs: torch.Tensor,
    length: torch.Tensor,
    budget: int,
    recent: int = 32,
) -> EvictionState:
    """Accumulate scores; evict the lowest-acc alive non-recent token if over
    budget."""
    acc = state.acc + probs
    pos = torch.arange(acc.shape[-1], dtype=torch.int32, device=acc.device)
    protected = pos[None, None, :] >= (length[:, None, None] - recent)
    evictable = state.alive & ~protected
    score = torch.where(evictable, acc, torch.full_like(acc, float("inf")))
    return EvictionState(_evict_one(state.alive, score, budget), acc)


# ----------------------------------------------------------------------- TOVA
def tova_step(
    state: EvictionState, probs: torch.Tensor, length: torch.Tensor, budget: int
) -> EvictionState:
    """Evict the alive token with the lowest *current* attention weight."""
    score = torch.where(state.alive, probs, torch.full_like(probs, float("inf")))
    return EvictionState(_evict_one(state.alive, score, budget), state.acc)


# --------------------------------------------------------------------- SnapKV
def snapkv_state(
    q_window: torch.Tensor,
    K: torch.Tensor,
    length: torch.Tensor,
    budget: int,
    *,
    window: int = 32,
    pool: int = 7,
) -> EvictionState:
    """One-shot prefill selection from the last ``window`` queries'
    attention, max-pooled over ``pool`` neighbouring positions, plus the
    observation window itself; the selected set is fixed afterwards.

    q_window: [B, Hq, W, D] (the last prefill queries)."""
    B, Hq, W, D = q_window.shape
    S, Hkv = K.shape[1], K.shape[2]
    dev = K.device
    qf = q_window.to(torch.float32).reshape(B, Hkv, Hq // Hkv, W, D)
    s = torch.einsum("bhrwd,bshd->bhrws", qf, K.to(torch.float32)) * _inv_sqrt(D, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    valid = pos[None, :] < length[:, None]  # [B, S]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).sum(dim=(2, 3))  # vote: [B, Hkv, S]
    # max-pool along the sequence with reduce_window's "SAME" padding: (pool-1)//2
    # on the left and pool//2 on the right, both -inf (so even pools match too)
    inf = float("inf")
    padded = F.pad(p, ((pool - 1) // 2, pool // 2), value=-inf)
    pooled = padded.unfold(-1, pool, 1).amax(dim=-1)
    ln = length[:, None, None]
    in_window = (pos[None, None, :] >= ln - window) & (pos[None, None, :] < ln)
    pooled = torch.where(valid[:, None, :], pooled, torch.full_like(pooled, -inf))
    pooled = torch.where(in_window, torch.full_like(pooled, inf), pooled)
    k = max(budget, window)
    idx = torch.sort(pooled, dim=-1, descending=True, stable=True).indices[..., :k]
    alive = torch.zeros((B, Hkv, S), dtype=torch.bool, device=dev)
    alive.scatter_(-1, idx, True)
    alive &= valid[:, None, :]
    return EvictionState(alive, torch.zeros((B, Hkv, S), dtype=torch.float32, device=dev))


def append_alive(state: EvictionState, length: torch.Tensor) -> EvictionState:
    """Mark the token just written at position ``length`` alive (all heads);
    a length at or past S marks nothing, as ``one_hot`` does."""
    S = state.alive.shape[-1]
    pos = torch.arange(S, device=length.device)
    onehot = (pos[None, :] == length[:, None].to(pos.dtype))[:, None, :]
    return EvictionState(state.alive | onehot, state.acc)
