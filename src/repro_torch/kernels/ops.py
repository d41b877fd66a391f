"""``CacheView``-level entry points of the FIER kernels and the building
blocks the JAX package exports.

* ``retrieve`` (K1 on a slab, K3 on a paged pool), ``attend_selected``
  (K2 / K4) and their chain ``fier_decode_one_pass``, the ``one_pass``
  pipeline of the ``fier`` backend;
* ``fier_score`` (K6), ``topk_select`` (plain ``masked_scores``, K7, plain
  ``compact_indices``) and their chain into K2, ``fier_decode_two_pass``,
  the slab-only ``two_pass`` pipeline;
* ``sparse_attention`` (K8 over pre-gathered rows), ``pack_quantize`` (K5)
  and the deprecated unfused chain ``fier_attention_decode``.

Port of ``repro.kernels.ops``.  The kernels read the seq-major cache and
side-car directly (paged: through the block table), so no layout
transpose happens here.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core import retrieval
from repro_torch.core.policy import CacheView
from repro_torch.core.quantize import QuantizedKeys

from .fier_score import fier_score_scan
from .fused_retrieval import fier_retrieve
from .pack_quantize import fier_pack_quantize
from .sparse_attention import fier_attend_gathered, fier_attend_selected
from .topk_select import compact_indices, fier_topk_threshold


def fier_score(q: torch.Tensor, qk: QuantizedKeys) -> torch.Tensor:
    """Packed 1-bit score scan (K6).  q [B, Hq, D], qk seq-major →
    f32 [B, Hq, S]."""
    B, Hq, D = q.shape
    Hkv = qk.codes.shape[2]
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    out = fier_score_scan(q4, qk.codes, qk.scale, qk.zero, group=qk.group)
    return out.reshape(B, Hq, qk.seq_len)


def topk_select(
    kv_scores: torch.Tensor,
    budget: int,
    length: torch.Tensor | None = None,
    *,
    sink: int = 0,
    recent: int = 0,
) -> torch.Tensor:
    """Threshold top-k selection, no sort: kv_scores f32 [B, Hkv, S] →
    idx int32 [B, Hkv, budget], the index set of ``retrieval.select_topk``
    ({ s > τ } ascending, then the first (budget − m) ties)."""
    B, Hkv, S = kv_scores.shape
    s = retrieval.masked_scores(kv_scores, length, sink=sink, recent=recent)
    s = s.reshape(B * Hkv, S)
    tau, m = fier_topk_threshold(s, budget)
    return compact_indices(s, tau, m, budget).reshape(B, Hkv, budget)


def sparse_attention(
    q: torch.Tensor,
    k_sel: torch.Tensor,
    v_sel: torch.Tensor,
    idx: torch.Tensor,
    length: torch.Tensor | None,
) -> torch.Tensor:
    """Decode attention over gathered rows (K8): q [B, Hq, D];
    k_sel/v_sel [B, k, Hkv, D]; idx [B, Hkv, k]; length [B] or None →
    [B, Hq, D] in q's dtype.  Slots with idx ≥ length are masked."""
    B, Hq, D = q.shape
    Hkv = k_sel.shape[2]
    if length is not None:
        valid = idx < length.to(idx.dtype)[:, None, None]
    else:
        valid = torch.ones_like(idx, dtype=torch.bool)
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    out = fier_attend_gathered(q4, k_sel, v_sel, valid.to(torch.int8))
    return out.reshape(B, Hq, D).to(q.dtype)


def pack_quantize(k: torch.Tensor, group: int) -> QuantizedKeys:
    """Quantize and pack a seq-major key slab [B, S, Hkv, D] (K5)."""
    codes, scale, zero = fier_pack_quantize(k, group)
    return QuantizedKeys(codes, scale, zero, group)


def retrieve(
    q: torch.Tensor,
    view: CacheView,
    budget: int,
    *,
    group_reduce: str = "max",
    sink: int = 0,
    recent: int = 0,
    return_stats: bool = False,
):
    """One-pass retrieval over a ``CacheView``: q [B, Hq, D] →
    idx int32 [B, Hkv, budget] (logical token positions).  With
    ``return_stats=True`` also (tau f32 [B, Hkv], m int32 [B, Hkv]): the
    budget-th score and the strictly-greater count per row."""
    qk = view.meta
    B, Hq, D = q.shape
    Hkv = qk.codes.shape[2]
    if view.layout == "paged":
        S = view.block_table.shape[1] * qk.codes.shape[1] * 8
    else:
        S = qk.seq_len
    if view.length is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
        recent = 0  # masked_scores applies `recent` only with a length
    else:
        lens = view.length.to(torch.int32)
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    table = view.block_table if view.layout == "paged" else None
    idx, tau, m = fier_retrieve(
        q4, qk.codes, qk.scale, qk.zero, lens, budget, group=qk.group,
        group_reduce=group_reduce, sink=sink, recent=recent, block_table=table,
    )
    if return_stats:
        return idx, tau, m
    return idx


def attend_selected(q: torch.Tensor, view: CacheView, idx: torch.Tensor) -> torch.Tensor:
    """Fused select-and-attend over a ``CacheView``: q [B, Hq, D],
    idx [B, Hkv, budget] → [B, Hq, D] in q's dtype."""
    B, Hq, D = q.shape
    Hkv = view.k.shape[2]
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    table = view.block_table if view.layout == "paged" else None
    out = fier_attend_selected(q4, view.k, view.v, idx, view.length, block_table=table)
    return out.reshape(B, Hq, D).to(q.dtype)


def fier_decode_one_pass(
    q: torch.Tensor,
    view: CacheView,
    budget: int,
    *,
    group_reduce: str = "max",
    sink: int = 0,
    recent: int = 0,
) -> torch.Tensor:
    """The ``one_pass`` FIER pipeline: K1/K3 retrieval (per-token scores
    never in device memory) chained into K2/K4 select-and-attend."""
    idx = retrieve(q, view, budget, group_reduce=group_reduce, sink=sink, recent=recent)
    return attend_selected(q, view, idx)


def fier_decode_two_pass(
    q: torch.Tensor,
    view: CacheView,
    budget: int,
    *,
    group_reduce: str = "max",
    sink: int = 0,
    recent: int = 0,
) -> torch.Tensor:
    """The ``two_pass`` FIER pipeline (slab layout only): K6 score scan →
    group reduction → K7 threshold select (f32 score tensors in device
    memory between them) → K2 select-and-attend.  Kept for ablation and
    the score-byte accounting; with ``group_reduce='max'`` it returns
    ``fier_decode_one_pass``'s output bit for bit."""
    if view.layout != "slab":
        raise ValueError("two_pass pipeline supports the slab layout only")
    Hkv = view.k.shape[2]
    scores = fier_score(q, view.meta)
    kv_scores = retrieval.reduce_over_query_group(scores, Hkv, group_reduce)
    idx = topk_select(kv_scores, budget, view.length, sink=sink, recent=recent)
    return attend_selected(q, view, idx)


def fier_attention_decode(
    q: torch.Tensor,
    K: torch.Tensor,
    V: torch.Tensor,
    qk: QuantizedKeys,
    budget: int,
    length: torch.Tensor | None = None,
    *,
    group_reduce: str = "max",
) -> torch.Tensor:
    """Deprecated unfused decode: K6 scores → ``select_topk`` (a sort) →
    materialised ``gather_kv`` → K8.  Compose the building blocks or use a
    ``DecodePlan`` pipeline instead."""
    warnings.warn(
        "kernels.ops.fier_attention_decode is deprecated; use "
        "policy.decode_attention(q, view, plan) or the fier_score / topk_select / "
        "sparse_attention building blocks",
        DeprecationWarning, stacklevel=2,
    )
    Hkv = K.shape[2]
    scores = fier_score(q, qk)
    kv_scores = retrieval.reduce_over_query_group(scores, Hkv, group_reduce)
    idx = retrieval.select_topk(kv_scores, budget, length)
    k_sel, v_sel = retrieval.gather_kv(K, V, idx)
    return sparse_attention(q, k_sel, v_sel, idx, length)
