"""Distributed FIER: sequence-sharded KV cache + log-sum-exp merge (port of
``repro.core.distributed``).

At a 500k-token context the KV cache of one request outgrows one device, so
the cache is sharded *along the sequence* and FIER's structure does the rest:

  1. every shard scans only its packed 1-bit slice,
  2. takes a *local* top-k over its slice,
  3. computes exact partial attention over its local winners,
  4. partial outputs merge with the flash-decoding log-sum-exp trick — one
     ``psum`` of (num·e^{m−M}, den·e^{m−M}) per layer: O(Hq·D) bytes,
     independent of context length.

Two selection modes:
  * ``local``: the budget split evenly across shards — no extra collective.
    An approximation of global top-k.
  * ``exact``: shards all-gather their local candidate scores, derive the
    global budget-th score τ, and keep local candidates ≥ τ.  Matches
    single-device FIER up to ties at τ; one small all-gather
    (n_shards · 2·budget/n_shards f32 per (B, Hkv)).

The reference runs these functions inside ``shard_map`` bodies, where
``jax.lax`` collectives bind a named mesh axis.  The port is
single-controller: a function here takes the tensors of every shard of one
axis group as lists in shard order (one entry per shard, each on its
shard's device), runs each shard's share, and calls the collectives below
between the shares.  The reference runs all of this as plain jnp (no Pallas
kernel), so plain PyTorch is the port.

The collectives take one tensor per shard of a group and give each shard
the result on its own device.  Their reduction order is fixed — shard 0
first, then 1, 2, … — so a result does not depend on which shard computes
it.  They are built from ``torch.add``, ``torch.maximum``, ``torch.cat``
and ``.to(device)``, so they are differentiable: inside one autograd graph
(the single-controller train step, ``models/sharded_train.py``) the backward of
an all-gather hands each shard its slice of the summed gradient (a
reduce-scatter) and the backward of a psum hands every shard the whole
gradient (a broadcast), with no hand-written transpose.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from . import retrieval
from .quantize import QuantizedKeys
from .retrieval import NEG_INF

DROPPED = 2**30  # an exact-mode nominee below τ is pushed past every length


# ------------------------------------------------------- the collective record

class CollectiveRecord:
    """What the collectives below did while :func:`recording` was active:
    one entry per call with a group of more than one shard, as the
    reference's HLO pass counts them (``repro/launch/dryrun.py``).  An
    entry is (kind, bytes, group size, charged devices, phase): ``kind``
    the reference's name of the collective; ``bytes`` the ring model's X
    for the kind (one piece for an all-reduce, the gathered output for an
    all-gather, one shard's output for a reduce-scatter); the devices it is
    charged to (every shard of the group, or the one shard that gathers);
    ``phase`` "forward", or "backward" for the transpose autograd runs (a
    gather's is the reduce-scatter of its gradient, a psum's a psum)."""

    def __init__(self):
        self.entries: list[tuple[str, int, int, tuple, str]] = []

    def note(self, kind: str, nbytes: int, n: int, devices, phase: str = "forward") -> None:
        if n > 1:
            self.entries.append((kind, int(nbytes), int(n), tuple(devices), phase))

    def summary(self) -> list[tuple[str, int, int, str]]:
        """The entries without their devices: what a run on fake devices and
        the same run with every shard on one device share."""
        return [(k, b, n, ph) for k, b, n, _, ph in self.entries]


_records: list[CollectiveRecord] = []
_wire = [0]  # > 0 while a collective (or autograd's transpose of one) moves bytes
_compound = [0]  # > 0 inside ``gathered``: its gathers are one record


@contextlib.contextmanager
def recording():
    """Record the collectives called inside (:class:`CollectiveRecord`)."""
    rec = CollectiveRecord()
    _records.append(rec)
    try:
        yield rec
    finally:
        _records.pop()


def in_collective() -> bool:
    """Whether the bytes moved now belong to a collective (its forward, or
    autograd's transpose of it) while recording."""
    return _wire[0] > 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _NoteTranspose(torch.autograd.Function):
    """Identity whose backward notes the transpose of a forward collective
    in the record: the values and gradients pass through unchanged."""

    @staticmethod
    def forward(ctx, note, *xs):
        ctx.note = note
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.note()
        return (None,) + gs


def _enter(x: torch.Tensor) -> None:
    _wire[0] += 1


def _leave(*_) -> None:
    _wire[0] -= 1


def move(x: torch.Tensor, device) -> torch.Tensor:
    """``x.to(device)`` as a collective moves it: inside a recorded
    collective, its backward copy is marked as the collective's too
    (``in_collective``)."""
    y = x.to(device)
    if _records and _wire[0] and y is not x and y.grad_fn is not None:
        y.grad_fn.register_prehook(_enter)
        y.grad_fn.register_hook(_leave)
    return y


def _recorded(kind: str, nbytes: int, n: int, devices, outs: list[torch.Tensor],
              transpose: tuple[str, int] | None) -> list[torch.Tensor]:
    """While recording, note a forward collective and route its outputs
    through a node whose backward notes ``transpose`` (kind, bytes) on the
    same devices."""
    if not _records:
        return outs
    rec = _records[-1]
    rec.note(kind, nbytes, n, devices)
    if transpose is None or not torch.is_grad_enabled() or not any(o.requires_grad for o in outs):
        return outs
    t_kind, t_bytes = transpose
    return list(_NoteTranspose.apply(
        lambda: rec.note(t_kind, t_bytes, n, devices, "backward"), *outs))


@contextlib.contextmanager
def _wired():
    _wire[0] += 1
    try:
        yield
    finally:
        _wire[0] -= 1


# ---------------------------------------------------------------- collectives

def _fold(xs: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    with _wired():
        acc = xs[0]
        for x in xs[1:]:
            acc = op(acc, move(x, acc.device))
        outs = [move(acc, x.device) for x in xs]
    n = _nbytes(xs[0])
    return _recorded("all-reduce", n, len(xs), [x.device for x in xs], outs,
                     ("all-reduce", n))


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Sum over one axis group: ((x0 + x1) + x2) + …, on every shard."""
    return _fold(xs, torch.add)


def pmax(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise maximum over one axis group, on every shard."""
    return _fold(xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Tiled all-gather: the shards' tensors concatenated along ``dim`` in
    shard order (``lax.all_gather(..., tiled=True)``), on every shard."""
    home = xs[0].device
    with _wired():
        cat = torch.cat([move(x, home) for x in xs], dim=dim)
        outs = [move(cat, x.device) for x in xs]
    return _recorded("all-gather", _nbytes(cat), len(xs), [x.device for x in xs], outs,
                     ("reduce-scatter", _nbytes(xs[0])))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, cat_dim: int) -> list[torch.Tensor]:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): shard j gets
    block j of every shard's tensor split evenly along ``split_dim``,
    joined along ``cat_dim`` in shard order, on its own device."""
    n = len(xs)
    with _wired():
        blocks = [x.chunk(n, dim=split_dim) for x in xs]
        outs = [torch.cat([move(blocks[i][j], xs[j].device) for i in range(n)], dim=cat_dim)
                for j in range(n)]
    nb = _nbytes(xs[0])
    return _recorded("all-to-all", nb, n, [x.device for x in xs], outs, ("all-to-all", nb))


def pmean(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Mean over one axis group (the psum over the shard count), on every
    shard."""
    return [x / len(xs) for x in psum(xs)]


def gather(xs: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """One shard's result of the tiled all-gather: the shards' tensors
    concatenated along ``dim`` in shard order, on ``device``."""
    with _wired():
        out = torch.cat([move(x, device) for x in xs], dim=dim)
    if _compound[0]:
        return out
    return _recorded("all-gather", _nbytes(out), len(xs), [out.device], [out],
                     ("reduce-scatter", _nbytes(xs[0])))[0]


def gathered(fn, n: int, piece_bytes: int, device) -> torch.Tensor:
    """``fn()`` (which gathers ``n`` pieces of ``piece_bytes`` each onto
    ``device`` through :func:`gather`, along several dims) recorded as one
    all-gather: a value split along two dims is one collective over its
    whole grid, as the reference's HLO has it."""
    _compound[0] += 1
    try:
        with _wired():
            out = fn()
    finally:
        _compound[0] -= 1
    return _recorded("all-gather", n * piece_bytes, n, [device], [out],
                     ("reduce-scatter", piece_bytes))[0]


# --------------------------------------------------------- partial attention

def _partial_attention(
    q: torch.Tensor,
    Ksel: torch.Tensor,
    Vsel: torch.Tensor,
    idx_global: torch.Tensor,
    length: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised attention over a shard's selected tokens.

    Returns (m [B,Hkv,rep], num [B,Hkv,rep,D], den [B,Hkv,rep]) in f32.
    Selected slots with idx >= length are masked.  bf16 operands with f32
    accumulation, written as f32 products of bf16-valued operands (every
    bf16×bf16 product is exact in f32).  Over the selected rows the f32
    upcast is small; ``full_decode_sharded`` upcasts whole shards (ROADMAP
    Queue 2b item 2 names the same cost on the skip layers)."""
    B, Hq, D = q.shape
    Hkv = Ksel.shape[2]
    rep = Hq // Hkv
    scale = retrieval._inv_sqrt(D, q.device)
    qb = q.to(Ksel.dtype).to(torch.float32).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qb, Ksel.to(torch.float32)) * scale
    invalid = idx_global[:, :, None, :] >= length[:, None, None, None]
    s = s.masked_fill(invalid, NEG_INF)
    m = s.amax(dim=-1)  # [B,Hkv,rep]
    # guard: a shard whose every candidate is invalid contributes nothing
    e = torch.exp(s - m[..., None]).masked_fill(invalid, 0.0)
    num = torch.einsum(
        "bhrk,bkhd->bhrd", e.to(Vsel.dtype).to(torch.float32), Vsel.to(torch.float32)
    )
    den = e.sum(dim=-1)
    return m, num, den


def lse_combine(
    m: Sequence[torch.Tensor], num: Sequence[torch.Tensor], den: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Merge the group's per-shard (m, num, den) → each shard's normalised
    output.  A shard whose m is −inf (nothing valid) weighs 0, not NaN."""
    M = pmax(m)
    w = [torch.where(torch.isfinite(mi), torch.exp(mi - Mi), torch.zeros_like(mi))
         for mi, Mi in zip(m, M)]
    num = psum([n * wi[..., None] for n, wi in zip(num, w)])
    den = psum([d * wi for d, wi in zip(den, w)])
    return [n / torch.clamp(d, min=1e-30)[..., None] for n, d in zip(num, den)]


# ------------------------------------------------------------ decode steps

def select_sharded(
    kv_scores: Sequence[torch.Tensor],
    budget: int,
    length: Sequence[torch.Tensor],
    *,
    shard_start: Sequence[int],
    n_shards: int,
    mode: str = "local",
) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Each shard's selection from its kv scores [B, Hkv, S_loc] (lists in
    shard order; ``length[i]`` [B] the global valid length).  Returns per
    shard (idx int32 [B, Hkv, k] local positions, drop): ``local`` takes the
    top ``budget // n_shards`` of the valid local positions (drop None);
    ``exact`` nominates up to twice that, and ``drop`` [B, Hkv, k] marks the
    nominees below the global budget-th candidate score τ (from one
    all-gather of the candidate scores) or invalid.  Ties go to the lower
    position, as ``lax.top_k`` breaks them (a stable descending sort)."""
    if mode not in ("local", "exact"):
        raise ValueError(f"unknown distributed mode {mode!r}")
    local_budget = max(budget // n_shards, 1)
    idxs, cands = [], []
    for kv, len_l, start in zip(kv_scores, length, shard_start):
        S_loc = kv.shape[-1]
        local_len = torch.clamp(len_l - start, 0, S_loc)  # [B]
        if mode == "local":
            idxs.append(retrieval.select_topk(kv, min(local_budget, S_loc), local_len))
            continue
        k_cand = min(max(local_budget * 2, 1) if n_shards > 1 else budget, S_loc)
        pos = torch.arange(S_loc, dtype=torch.int32, device=kv.device)
        masked = torch.where(pos[None, None, :] < local_len[:, None, None], kv,
                             torch.full_like(kv, NEG_INF))
        srt = torch.sort(masked, dim=-1, descending=True, stable=True)
        cands.append(srt.values[..., :k_cand])
        idxs.append(srt.indices[..., :k_cand].to(torch.int32))
    if mode == "local":
        return [(idx, None) for idx in idxs]
    out = []
    for idx, cand_s, all_s in zip(idxs, cands, all_gather(cands, dim=-1)):
        kth = torch.topk(all_s, min(budget, all_s.shape[-1]), dim=-1).values[..., -1:]
        out.append((idx, (cand_s < kth) | (cand_s <= NEG_INF)))
    return out


def selected_mask(selection, shard_start: Sequence[int], length: torch.Tensor,
                  S: int) -> torch.Tensor:
    """The global positions a sharded selection attends to, as a bool mask
    [B, Hkv, S] on ``length``'s device (kept nominees below ``length``) —
    what the checks compare with the single-device top-k."""
    B, Hkv = length.shape[0], selection[0][0].shape[1]
    mask = torch.zeros((B, Hkv, S + 1), dtype=torch.bool, device=length.device)
    for (idx, drop), start in zip(selection, shard_start):
        g = idx.to(length.device, torch.int64) + start
        keep = g < length.to(torch.int64)[:, None, None]
        if drop is not None:
            keep &= ~drop.to(length.device)
        mask.scatter_(2, torch.where(keep, g, torch.full_like(g, S)), True)
    return mask[..., :S]


def fier_decode_sharded(
    q: Sequence[torch.Tensor],
    K_loc: Sequence[torch.Tensor],
    V_loc: Sequence[torch.Tensor],
    qk_loc: Sequence[QuantizedKeys],
    budget: int,
    length: Sequence[torch.Tensor],
    *,
    shard_start: Sequence[int],
    n_shards: int,
    group_reduce: str = "max",
    mode: str = "local",
) -> list[torch.Tensor]:
    """One FIER decode step over the sequence shards of one axis group.

    Per shard i (lists in shard order): q[i] [B, Hq, D] (replicated),
    K_loc[i]/V_loc[i] [B, S_loc, Hkv, D], qk_loc[i] the packed side-car over
    the local slice, length[i] [B] the *global* valid length, shard_start[i]
    the global position of the shard's first token.  Returns each shard's
    merged, normalised output [B, Hq, D] (equal on every shard)."""
    kv = [retrieval.reduce_over_query_group(retrieval.approx_scores(q_l, qk_l),
                                            K_l.shape[2], group_reduce)
          for q_l, qk_l, K_l in zip(q, qk_loc, K_loc)]
    selection = select_sharded(kv, budget, length, shard_start=shard_start,
                               n_shards=n_shards, mode=mode)
    ms, nums, dens = [], [], []
    for (idx, drop), q_l, K_l, V_l, len_l, start in zip(
            selection, q, K_loc, V_loc, length, shard_start):
        Ksel, Vsel = retrieval.gather_kv(K_l, V_l, idx)
        idx_global = idx + start
        if drop is not None:
            # dropped nominees are pushed past ``length``: masked in attention
            idx_global = torch.where(drop, torch.full_like(idx_global, DROPPED), idx_global)
        m, num, den = _partial_attention(q_l, Ksel, Vsel, idx_global, len_l)
        ms.append(m), nums.append(num), dens.append(den)
    return [o.reshape(q_l.shape).to(q_l.dtype) for o, q_l in zip(lse_combine(ms, nums, dens), q)]


def full_decode_sharded(
    q: Sequence[torch.Tensor],
    K_loc: Sequence[torch.Tensor],
    V_loc: Sequence[torch.Tensor],
    length: Sequence[torch.Tensor],
    *,
    shard_start: Sequence[int],
) -> list[torch.Tensor]:
    """Dense decode attention over the sequence shards of one axis group
    (flash-decoding's LSE merge) — the Full-KV baseline at long context.
    Arguments as :func:`fier_decode_sharded`'s."""
    ms, nums, dens = [], [], []
    for q_l, K_l, V_l, len_l, start in zip(q, K_loc, V_loc, length, shard_start):
        B, S_loc, Hkv = K_l.shape[:3]
        idx = torch.arange(S_loc, dtype=torch.int32, device=K_l.device)
        idx = idx[None, None, :].expand(B, Hkv, S_loc)
        m, num, den = _partial_attention(q_l, K_l, V_l, idx + start, len_l)
        ms.append(m), nums.append(num), dens.append(den)
    return [o.reshape(q_l.shape).to(q_l.dtype) for o, q_l in zip(lse_combine(ms, nums, dens), q)]
