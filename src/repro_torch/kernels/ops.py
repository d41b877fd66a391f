"""``CacheView``-level entry points of the FIER kernels: ``retrieve``
(K1 on a slab, K3 on a paged pool), ``attend_selected`` (K2 / K4) and their
chain ``fier_decode_one_pass``, the ``one_pass`` pipeline of the ``fier``
backend.

Port of ``repro.kernels.ops`` ``:126-261``.  The kernels read the seq-major
cache and side-car directly (paged: through the block table), so no layout
transpose and no gather happens here.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import CacheView

from .fused_retrieval import fier_retrieve
from .sparse_attention import fier_attend_selected


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
