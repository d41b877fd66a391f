"""Comparison of two K1 selections, and a recorder that holds the
sequence-sharded decode's selections to the plain top-k and to K1
(``ShardedSelections``), for the checks (the CPU parity tests and
``chip_smoke.py``); nothing on the serving path calls them."""
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


class ShardedSelections:
    """A recorder of every exact-mode FIER call of the sequence-sharded
    decode (``core.distributed.fier_decode_sharded``: one per layer, step and
    batch shard), for the mesh checks.  Each call's sharded selection (the
    positions ``select_sharded`` keeps) is held to two selections on the
    same query and the same side-car joined along the sequence:

    * the plain top-``budget`` over the same score expression
      (``approx_scores``): they may differ only at scores within ε of its τ
      (the summation order), so a shard misplaced or ranked wrong shows
      (``outside``);
    * K1's (``ops.fier_retrieve``), what the one-device decode attends: K1
      ranks the kernels' score expression (``retrieval_scores``), so they may
      also part within 2δ + ε of K1's τ, δ the call's largest gap between
      the two expressions over its valid positions (``k1_outside``; ``delta``
      and the band's share ``near`` / ``valid`` are recorded).

    ``eps(q4, qk)`` gives ε for the call's grouped query [B, Hkv, rep, D] and
    joined side-car; ``sync`` (optional) waits for the device, so that a
    record's ``seconds`` are the check's own.  With ``fault`` set, each
    shard selects from the next shard's scores (a planted fault).  Used as a
    context manager, it patches ``core.distributed`` inside the block."""

    def __init__(self, eps, sync=None):
        self.eps, self.sync, self.fault = eps, sync, False
        self.calls: list[dict] = []

    def __enter__(self):
        from repro_torch.core import distributed as dist

        self._saved = dist.fier_decode_sharded, dist.select_sharded
        dist.fier_decode_sharded = self._recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distributed as dist

        dist.fier_decode_sharded, dist.select_sharded = self._saved

    def _recorded(self, q, K, V, qk, budget, length, *, shard_start, group_reduce="max", **kw):
        import time

        from repro_torch.core import distributed as dist

        decode, select = self._saved
        masks = []

        def selecting(kv, budget, length, **skw):
            sel = select(list(kv[1:]) + list(kv[:1]) if self.fault else kv, budget, length,
                         **skw)
            masks.append(dist.selected_mask(sel, skw["shard_start"], length[0],
                                            sum(k.shape[-1] for k in kv)))
            return sel

        dist.select_sharded = selecting
        try:
            out = decode(q, K, V, qk, budget, length, shard_start=shard_start,
                         group_reduce=group_reduce, **kw)
        finally:
            dist.select_sharded = select
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        self.calls.append(self._check(q[0], qk, budget, length[0], group_reduce, masks[0]))
        self.calls[-1]["seconds"] = time.perf_counter() - t0
        return out

    def _check(self, q, qk, budget, length, group_reduce, sharded) -> dict:
        from repro_torch.core import retrieval as rt
        from repro_torch.core.quantize import QuantizedKeys

        from . import ops
        from .fier_score import retrieval_scores
        from .fused_retrieval import masked_kv

        dev = q.device
        join = lambda f: torch.cat([getattr(c, f).to(dev) for c in qk], dim=1)
        codes, scale, zero = join("codes"), join("scale"), join("zero")
        B, Hq, D = q.shape
        Hkv, S, g = codes.shape[2], codes.shape[1] * 8, qk[0].group
        q4, lens = q.reshape(B, Hkv, Hq // Hkv, D), length.to(dev)
        joined = QuantizedKeys(codes, scale, zero, g)
        eps = self.eps(q4, joined)
        valid = torch.arange(S, device=dev)[None, None, :] < lens[:, None, None]
        mark = lambda idx: torch.zeros((B, Hkv, S), dtype=torch.bool, device=dev).scatter_(
            2, idx.to(torch.int64), True) & valid
        sharded = sharded.to(dev)
        # the same expression ranked whole
        kv_ref = rt.reduce_over_query_group(rt.approx_scores(q, joined), Hkv, group_reduce)
        top = torch.where(valid, kv_ref, rt.NEG_INF).topk(min(budget, S), dim=-1)
        tau_ref = torch.where(lens[:, None] >= budget, top.values[..., -1], rt.NEG_INF)
        near_ref = ((kv_ref - tau_ref[..., None]).abs() <= eps) & valid
        diff_ref = sharded ^ mark(top.indices)
        # K1, on the kernels' expression
        idx, tau, _ = ops.fier_retrieve(q4, codes, scale, zero, lens, budget, group=g,
                                        group_reduce=group_reduce)
        kv = masked_kv(retrieval_scores(q4, codes, scale, zero, group=g), lens, 0, 0,
                       group_reduce)
        delta = float(torch.where(valid, kv - kv_ref, 0.0).abs().max())
        near = ((kv - tau[..., None]).abs() <= 2 * delta + eps) & valid
        diff = sharded ^ mark(idx)
        return dict(outside=int((diff_ref & ~near_ref).sum()), diff_ref=int(diff_ref.sum()),
                    near_ref=int(near_ref.sum()), k1_outside=int((diff & ~near).sum()),
                    diff=int(diff.sum()), near=int(near.sum()), delta=delta, eps=eps,
                    valid=int(valid.expand(B, Hkv, S).sum()), selected=int(sharded.sum()))

    def totals(self) -> dict:
        """The records summed (``delta`` and ``eps``: their largest)."""
        assert self.calls, "no exact-mode FIER call was recorded"
        return {k: (max if k in ("delta", "eps") else sum)(c[k] for c in self.calls)
                for k in self.calls[0]}
