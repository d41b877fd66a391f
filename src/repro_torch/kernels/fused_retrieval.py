"""K1: one-pass FIER retrieval — the port of the TPU kernel
``repro.kernels.fused_retrieval.fused_retrieve_hm``.

Per (batch, kv-head) row: score every cached token from its packed 1-bit
code and group (scale, zero) with the ``score_block`` expression, reduce
over the query group (max/sum), mask positions ≥ length to −1e30 and the
sink/recent guard-rails to +inf, and select the ``budget`` largest: the
index set { key > τ } ∪ the first (budget − m) ties in ascending position,
where τ is the budget-th largest key and m the strictly-greater count.

``fier_retrieve`` reads the seq-major side-car of the cache directly
(codes [B, S/8, Hkv, D], scale/zero [B, S/g, Hkv, D]) — no head-major copy.
On a CUDA tensor it launches ``csrc/fier_retrieve.cu`` (scores and keys
live in registers and shared memory, never in device memory); on a CPU
tensor it runs :func:`fier_retrieve_plain`, the same function in plain
PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.retrieval import NEG_INF

from . import build
from .fier_score import score_block
from .topk_select import _sortable_keys, _unsortable

launches = 0  # kernel launches since the last reset (the chip check reads it)

# shared memory a block may use on sm_90, and what the kernel keeps beside
# the row's keys (q in f32 for up to 8 query heads × 128 dims, the radix
# histogram, scan scratch)
SMEM_LIMIT = 232448
SMEM_STATIC = 8 * 128 * 4 + 256 * 4 + 256
MAX_ROW_TOKENS = (SMEM_LIMIT - SMEM_STATIC) // 4
# the one d_head the card has checked the kernel at (chip_smoke.py phase 2);
# a slice that brings another adds it to the .cu and to that phase
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8


def masked_keys(
    s: torch.Tensor, lengths: torch.Tensor, sink: int, recent: int, group_reduce: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-reduce [B, Hkv, rep, S] scores, apply the guard-rails
    (``_masked_block_keys``) and lift to keys.  Returns (kv f32, keys)."""
    if group_reduce == "max":
        kv = s.amax(dim=2)
    elif group_reduce == "sum":
        kv = s.sum(dim=2)
    else:
        raise ValueError(f"unknown group reduction {group_reduce!r}")
    S = kv.shape[-1]
    pos = torch.arange(S, dtype=torch.int32, device=kv.device)[None, None, :]
    length = lengths.to(torch.int32)[:, None, None]
    kv = torch.where(pos < length, kv, torch.full_like(kv, NEG_INF))
    inf = torch.full_like(kv, float("inf"))
    if sink > 0:
        kv = torch.where(pos < sink, inf, kv)
    if recent > 0:
        kv = torch.where((pos >= length - recent) & (pos < length), inf, kv)
    return kv, _sortable_keys(kv)


def threshold_select(keys: torch.Tensor, budget: int):
    """τ search + tie-aware compaction over keys [R, S] (int64 holding
    uint32).  Returns (idx int32 [R, budget], tau_key int64 [R], m int32 [R])."""
    R, S = keys.shape
    tau_key = torch.sort(keys, dim=-1, descending=True).values[:, budget - 1]
    gt = keys > tau_key[:, None]
    tie = keys == tau_key[:, None]
    m = gt.sum(dim=-1)
    cgt = torch.cumsum(gt, dim=-1)
    ctie = torch.cumsum(tie, dim=-1)
    take_tie = tie & (ctie <= (budget - m)[:, None])
    dest = torch.where(
        gt, cgt - 1,
        torch.where(take_tie, m[:, None] + ctie - 1, torch.full_like(cgt, budget)),
    )
    pos = torch.arange(S, dtype=torch.int32, device=keys.device).expand(R, S)
    out = torch.zeros((R, budget + 1), dtype=torch.int32, device=keys.device)
    out.scatter_(1, dest, pos)  # column `budget` collects the dropped entries
    return out[:, :budget], tau_key, m.to(torch.int32)


def retrieval_scores(q, codes, scale, zero, *, group: int) -> torch.Tensor:
    """Per-query-head scores [B, Hkv, rep, S] of the ``score_block``
    expression over a seq-major side-car."""
    to_hm = lambda a: a.permute(0, 2, 1, 3)  # [B, Hkv, S/x, D]
    return score_block(q, to_hm(codes), to_hm(scale), to_hm(zero), group=group)


def fier_retrieve_plain(
    q, codes, scale, zero, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
):
    """The plain PyTorch version of K1 (same arguments as
    :func:`fier_retrieve`).  Materialises the scores; the kernel does not."""
    B, Hkv, rep, D = q.shape
    s = retrieval_scores(q, codes, scale, zero, group=group)
    _, keys = masked_keys(s, lengths, sink, recent, group_reduce)
    S = keys.shape[-1]
    idx, tau_key, m = threshold_select(keys.reshape(B * Hkv, S), budget)
    tau = _unsortable(tau_key)
    return (
        idx.reshape(B, Hkv, budget), tau.reshape(B, Hkv), m.reshape(B, Hkv)
    )


def _check(q, codes, scale, zero, lengths, budget, group, group_reduce):
    if q.dim() != 4 or codes.dim() != 4:
        raise ValueError(f"q must be [B,Hkv,rep,D], codes [B,S/8,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(codes.shape)}")
    B, Hkv, rep, D = q.shape
    S = codes.shape[1] * 8
    if group <= 0 or group % 8 or S % group:
        raise ValueError(f"group {group} must be a multiple of 8 dividing S={S}")
    if tuple(codes.shape) != (B, S // 8, Hkv, D) or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 [{B},{S // 8},{Hkv},{D}], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    for name, a in (("scale", scale), ("zero", zero)):
        if tuple(a.shape) != (B, S // group, Hkv, D) or a.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 [{B},{S // group},{Hkv},{D}], "
                             f"got {a.dtype} {tuple(a.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    if not 0 < budget <= S:
        raise ValueError(f"budget {budget} must be in (0, S={S}]")
    if group_reduce not in ("max", "sum"):
        raise ValueError(f"unknown group reduction {group_reduce!r}")
    devs = {t.device for t in (q, codes, scale, zero, lengths)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return B, Hkv, rep, D, S


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_retrieve").fier_retrieve_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fier_retrieve(
    q, codes, scale, zero, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
):
    """One-pass retrieval.

    q [B, Hkv, rep, D] (rounded to bf16, as the reference kernel does);
    codes uint8 [B, S/8, Hkv, D]; scale/zero bf16 [B, S/g, Hkv, D];
    lengths int32 [B] → (idx int32 [B, Hkv, budget], tau f32 [B, Hkv],
    m int32 [B, Hkv]).
    """
    global launches
    B, Hkv, rep, D, S = _check(q, codes, scale, zero, lengths, budget, group, group_reduce)
    dev = q.device
    if dev.type == "cpu":
        return fier_retrieve_plain(
            q, codes, scale, zero, lengths, budget,
            group=group, group_reduce=group_reduce, sink=sink, recent=recent,
        )
    if dev.type != "cuda":
        raise ValueError(f"fier_retrieve runs on cuda or cpu, not {dev}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    if rep > KERNEL_MAX_REP:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_REP} query "
                         f"heads per kv head, got {rep}")
    if S > MAX_ROW_TOKENS:
        raise ValueError(
            f"S={S} tokens: one row's keys ({4 * S} bytes) do not fit in the "
            f"{SMEM_LIMIT}-byte shared memory of a block (limit {MAX_ROW_TOKENS} "
            f"tokens); the long-row variant that re-scores per sweep is "
            f"ROADMAP Queue 2 (K1 long rows)"
        )
    q = q.to(torch.bfloat16).contiguous()
    codes, scale, zero = codes.contiguous(), scale.contiguous(), zero.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    idx = torch.empty((B, Hkv, budget), dtype=torch.int32, device=dev)
    tau = torch.empty((B, Hkv), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        lengths.data_ptr(), idx.data_ptr(), tau.data_ptr(), m.data_ptr(),
        B, S, Hkv, rep, D, group, budget, int(group_reduce == "sum"),
        sink, recent, stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_retrieve kernel launch failed: cudaError {err}")
    launches += 1
    return idx, tau, m

