"""Quest (Tang et al., 2024) page-level KV retrieval — the paper's main
baseline.  Port of ``repro.core.quest``; plain PyTorch.

Pages of ``L`` consecutive tokens store per-channel min/max vectors; a
page's importance for query ``q`` is the box upper bound
    s_P = Σ_d max(q_d · kmax_d, q_d · kmin_d)                       (Quest)
(``reduce="max"`` keeps the FIER paper's printed max over d for the
ablation).  ``quant_page_scores`` is the Tab. 3 "Quest-p16-w/quant"
ablation: the mean 1-bit approximate score of a page's tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from . import retrieval
from .quantize import QuantizedKeys


@dataclasses.dataclass
class PageMeta:
    """kmax/kmin: bf16 [B, S//L, Hkv, D] (a stacked cache carries a leading
    layer axis); ``page`` is the tokens per page L."""

    kmax: torch.Tensor
    kmin: torch.Tensor
    page: int

    FIELDS = ("kmax", "kmin")

    def layer(self, i: int) -> "PageMeta":
        """The page metadata of layer ``i`` of a stacked cache (views, so
        in-place updates reach the stack)."""
        return PageMeta(self.kmax[i], self.kmin[i], self.page)


def build_page_meta(K: torch.Tensor, page: int) -> PageMeta:
    """Per-page channel max/min of a key slab [B, S, Hkv, D], in K's dtype
    and then rounded to bf16."""
    B, S, H, D = K.shape
    if S % page != 0:
        raise ValueError(f"seq {S} not divisible by page {page}")
    Kp = K.reshape(B, S // page, page, H, D)
    return PageMeta(
        Kp.amax(dim=2).to(torch.bfloat16), Kp.amin(dim=2).to(torch.bfloat16), page
    )


def page_scores(q: torch.Tensor, meta: PageMeta, reduce: str = "sum") -> torch.Tensor:
    """Upper-bound page scores in f32.  q [B, Hq, D] → [B, Hq, P]."""
    B, Hq, D = q.shape
    Hkv = meta.kmax.shape[2]
    qf = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    amax = qf[:, None] * meta.kmax.to(torch.float32)[:, :, :, None, :]
    amin = qf[:, None] * meta.kmin.to(torch.float32)[:, :, :, None, :]
    per_chan = torch.maximum(amax, amin)  # [B, P, Hkv, rep, D]
    if reduce == "sum":
        s = per_chan.sum(dim=-1)
    elif reduce == "max":
        s = per_chan.amax(dim=-1)
    else:
        raise ValueError(reduce)
    return s.permute(0, 2, 3, 1).reshape(B, Hq, -1)


def quant_page_scores(q: torch.Tensor, qk: QuantizedKeys, page: int) -> torch.Tensor:
    """Tab. 3 ablation: mean 1-bit score per page.  → [B, Hq, P]."""
    s = retrieval.approx_scores(q, qk)  # [B, Hq, S]
    B, Hq, S = s.shape
    return s.reshape(B, Hq, S // page, page).mean(dim=-1)


def quest_token_indices(
    kv_page_scores: torch.Tensor,
    budget: int,
    page: int,
    length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Select the top ``max(budget // page, 1)`` pages and expand them to
    token indices: kv_page_scores [B, Hkv, P] (already reduced over the
    query group) → int32 [B, Hkv, n_pages·page].  A page is selectable iff
    it holds a valid token; ties (the masked pages all tie at NEG_INF) go
    to the lower page, as ``lax.top_k`` breaks them (a stable descending
    sort, not ``torch.topk``)."""
    B, Hkv, P = kv_page_scores.shape
    n_pages = max(budget // page, 1)
    s = kv_page_scores
    if length is not None:
        first_tok = torch.arange(P, dtype=torch.int32, device=s.device) * page
        valid = first_tok[None, None, :] < length[:, None, None]
        s = torch.where(valid, s, torch.tensor(retrieval.NEG_INF, dtype=s.dtype, device=s.device))
    pidx = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :n_pages]
    offs = torch.arange(page, dtype=torch.int64, device=s.device)
    idx = pidx[..., None] * page + offs  # [B, Hkv, n_pages, page]
    return idx.reshape(B, Hkv, n_pages * page).to(torch.int32)


def quest_attention_decode(
    q: torch.Tensor,
    K: torch.Tensor,
    V: torch.Tensor,
    meta: PageMeta,
    budget: int,
    length: torch.Tensor | None = None,
    *,
    group_reduce: str = "max",
    reduce: str = "sum",
) -> torch.Tensor:
    """End-to-end Quest decode step (page select → exact attention over the
    selected pages' tokens; tokens at or past ``length`` are masked)."""
    Hkv = K.shape[2]
    ps = page_scores(q, meta, reduce=reduce)
    kv_ps = retrieval.reduce_over_query_group(ps, Hkv, group_reduce)
    idx = quest_token_indices(kv_ps, budget, meta.page, length)
    Ksel, Vsel = retrieval.gather_kv(K, V, idx)
    return retrieval.sparse_attention(q, Ksel, Vsel, idx, length)
