"""FIER retrieval oracles: approximate scores from 1-bit keys → top-k → exact
attention.  Port of ``repro.core.retrieval``; plain PyTorch, materialising
every intermediate.  These are the ``pipeline='reference'`` decode path and
the oracles the kernels are checked against; ``full_attention_decode`` is
also the real decode path of the skip layers.

Shapes (decode step):
    q        [B, Hq, D]          one new query per sequence
    K, V     [B, S, Hkv, D]      cache slabs (bf16)
    qk                           ``QuantizedKeys`` over the same slab
    length   [B] int32           valid prefix length per sequence

"bf16 operands, f32 accumulation" is written as an f32 product of
bf16-valued operands: every bf16×bf16 product is exact in f32, so only the
summation order can differ from the reference.
"""
from __future__ import annotations

import torch

from .quantize import QuantizedKeys, unpack_bits

NEG_INF = -1e30


def _inv_sqrt(D: int, device: torch.device) -> torch.Tensor:
    """1/sqrt(D) evaluated in f32, as ``1.0 / jnp.sqrt(jnp.asarray(D, f32))``."""
    return 1.0 / torch.sqrt(torch.full((), float(D), dtype=torch.float32, device=device))


def approx_scores(q: torch.Tensor, qk: QuantizedKeys) -> torch.Tensor:
    """s̃ = (q ⊙ s_G)·(±1) + q·z_G from packed codes.  Returns f32 [B, Hq, S].

    The jnp oracle's expression (``repro.core.retrieval._approx_scores_block``),
    unblocked: bf16-valued operands, f32 arithmetic.  It differs from the
    kernels' ``score_block`` expression, which rounds the dequantized key to
    bf16 before the dot."""
    B, Hq, D = q.shape
    g = qk.group
    S = qk.seq_len
    Hkv = qk.codes.shape[2]
    rep = Hq // Hkv
    bits = unpack_bits(qk.codes).to(torch.float32)
    pm1 = (bits * 2.0 - 1.0).reshape(B, S // g, g, Hkv, D)
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(B, Hkv, rep, D)
    qs = qf[:, None] * qk.scale.to(torch.float32)[:, :, :, None, :]
    const = torch.einsum("bhrd,bghd->bghr", qf, qk.zero.to(torch.float32))
    s = torch.einsum("bghrd,bgthd->bghrt", qs, pm1) + const[..., None]
    return s.permute(0, 2, 3, 1, 4).reshape(B, Hq, S)


def exact_scores(q: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Ground-truth scores q·Kᵀ in f32 (no softmax scaling — ranking only):
    q [B, Hq, D], K [B, S, Hkv, D] → [B, Hq, S]."""
    B, Hq, D = q.shape
    Hkv = K.shape[2]
    qf = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhrd,bshd->bhrs", qf, K.to(torch.float32))
    return s.reshape(B, Hq, -1)


def reduce_over_query_group(
    scores: torch.Tensor, n_kv: int, mode: str = "max"
) -> torch.Tensor:
    """GQA extension: [B, Hq, S] → [B, Hkv, S] so top-k is per KV head."""
    B, Hq, S = scores.shape
    s = scores.reshape(B, n_kv, Hq // n_kv, S)
    if mode == "max":
        return s.amax(dim=2)
    if mode == "sum":
        return s.sum(dim=2)
    raise ValueError(f"unknown group reduction {mode!r}")


def masked_scores(
    scores: torch.Tensor,
    length: torch.Tensor | None = None,
    *,
    sink: int = 0,
    recent: int = 0,
) -> torch.Tensor:
    """Selection guard-rails on raw scores [B, Hkv, S]: positions ≥ length
    → NEG_INF; the first ``sink`` and the last ``recent`` valid positions →
    +inf (in that order, as the reference applies them)."""
    B, Hkv, S = scores.shape
    pos = torch.arange(S, dtype=torch.int32, device=scores.device)
    s = scores
    inf = torch.full((), float("inf"), dtype=s.dtype, device=s.device)
    if length is not None:
        valid = pos[None, None, :] < length[:, None, None]
        s = torch.where(valid, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    if sink > 0:
        s = torch.where(pos[None, None, :] < sink, inf, s)
    if recent > 0 and length is not None:
        is_recent = pos[None, None, :] >= (length - recent)[:, None, None]
        is_recent &= pos[None, None, :] < length[:, None, None]
        s = torch.where(is_recent, inf, s)
    return s


def select_topk(
    scores: torch.Tensor,
    budget: int,
    length: torch.Tensor | None = None,
    *,
    sink: int = 0,
    recent: int = 0,
) -> torch.Tensor:
    """Top-``budget`` token indices per (batch, kv-head): [B, Hkv, S] →
    int32 [B, Hkv, budget].  A stable descending sort, so ties go to the
    lower position as ``lax.top_k`` breaks them."""
    s = masked_scores(scores, length, sink=sink, recent=recent)
    idx = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :budget]
    return idx.to(torch.int32)


def gather_kv(
    K: torch.Tensor, V: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather selected rows: K,V [B,S,Hkv,D], idx [B,Hkv,k] → [B,k,Hkv,D]."""
    D = K.shape[-1]
    ix = idx.to(torch.int64)[..., None].expand(-1, -1, -1, D)
    Ksel = torch.gather(K.transpose(1, 2), 2, ix)
    Vsel = torch.gather(V.transpose(1, 2), 2, ix)
    return Ksel.transpose(1, 2), Vsel.transpose(1, 2)


def sparse_attention(
    q: torch.Tensor,
    Ksel: torch.Tensor,
    Vsel: torch.Tensor,
    idx: torch.Tensor,
    length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact softmax attention over the selected tokens (1 query).

    q [B,Hq,D], Ksel/Vsel [B,k,Hkv,D], idx [B,Hkv,k] → out [B,Hq,D].
    Slots with idx >= length are masked.  q and the probabilities are
    rounded to the cache dtype before their products, as in the reference.
    """
    B, Hq, D = q.shape
    Hkv = Ksel.shape[2]
    rep = Hq // Hkv
    scale = _inv_sqrt(D, q.device)
    qb = q.to(Ksel.dtype).to(torch.float32).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qb, Ksel.to(torch.float32)) * scale
    if length is not None:
        invalid = idx[:, :, None, :] >= length[:, None, None, None]
        s = s.masked_fill(invalid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum(
        "bhrk,bkhd->bhrd", p.to(Vsel.dtype).to(torch.float32), Vsel.to(torch.float32)
    )
    return out.reshape(B, Hq, D).to(q.dtype)


def full_attention_decode(
    q: torch.Tensor,
    K: torch.Tensor,
    V: torch.Tensor,
    length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense decode attention over the whole cache (the skip layers and the
    Full-KV baseline).  Same numerics as ``sparse_attention``."""
    B, Hq, D = q.shape
    S, Hkv = K.shape[1], K.shape[2]
    rep = Hq // Hkv
    scale = _inv_sqrt(D, q.device)
    qb = q.to(K.dtype).to(torch.float32).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bshd->bhrs", qb, K.to(torch.float32)) * scale
    if length is not None:
        pos = torch.arange(S, dtype=torch.int32, device=q.device)
        valid = pos[None, None, None, :] < length[:, None, None, None]
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum(
        "bhrs,bshd->bhrd", p.to(V.dtype).to(torch.float32), V.to(torch.float32)
    )
    return out.reshape(B, Hq, D).to(q.dtype)


def fier_decode_reference(
    q: torch.Tensor,
    K: torch.Tensor,
    V: torch.Tensor,
    qk: QuantizedKeys,
    budget: int,
    length: torch.Tensor | None = None,
    *,
    group_reduce: str = "max",
    sink: int = 0,
    recent: int = 0,
    use_kernels: bool = False,
) -> torch.Tensor:
    """The reference FIER decode step: score → ``select_topk`` →
    ``gather_kv`` → ``sparse_attention``, every intermediate materialised.
    It runs no custom kernel unless ``use_kernels=True``, which scores with
    the score-scan kernel K6 (``kernels.ops.fier_score``, the
    ``score_block`` expression) instead of ``approx_scores``; selection and
    attention stay plain."""
    Hkv = K.shape[2]
    if use_kernels:
        from repro_torch.kernels import ops as kops

        scores = kops.fier_score(q, qk)
    else:
        scores = approx_scores(q, qk)
    kv_scores = reduce_over_query_group(scores, Hkv, group_reduce)
    idx = select_topk(kv_scores, budget, length, sink=sink, recent=recent)
    Ksel, Vsel = gather_kv(K, V, idx)
    return sparse_attention(q, Ksel, Vsel, idx, length)
