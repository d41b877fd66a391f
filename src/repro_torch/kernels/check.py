"""Comparison of two K1 selections, for the kernel checks (the CPU parity
tests and ``chip_smoke.py``); nothing on the serving path calls it."""
from __future__ import annotations

import torch


def selection_agrees(idx_a, idx_b, tau_a, tau_b, m_a, m_b, kv_scores, eps: float):
    """Compare two selections of one row set, up to scores within ``eps`` of τ.

    idx_* [R, budget]; tau_*/m_* [R]; kv_scores [R, S] the masked kv scores
    of one of them.  The index sets must be equal except for positions whose
    score lies within ``eps`` of τ (a near-tie whose order the summation
    order can flip); τ must agree within ``eps``; m may differ by at most
    the number of such near-ties.  Returns (ok, number of differing indices).
    """
    R, S = kv_scores.shape
    dev = kv_scores.device
    mark = lambda idx: torch.zeros((R, S), dtype=torch.bool, device=dev).scatter_(
        1, idx.to(torch.int64), True
    )
    diff = mark(idx_a) ^ mark(idx_b)
    tau = tau_b.to(torch.float32)[:, None]
    near = ((kv_scores - tau).abs() <= eps) | (kv_scores == tau)
    ok = bool((~diff | near).all())
    inf_or_close = (tau_a == tau_b) | ((tau_a - tau_b).abs() <= eps)
    ok &= bool(inf_or_close.all())
    ok &= bool(((m_a - m_b).abs() <= near.sum(dim=1)).all())
    return ok, int(diff.sum())
