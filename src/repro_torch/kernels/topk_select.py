"""K7: the two-pass threshold search — the port of the TPU kernel
``repro.kernels.topk_select.topk_threshold_hm`` — with its helpers: the
monotone uint32 keys (``_canon`` / ``_sortable_keys`` / ``_unsortable``)
and the sort-free compaction ``compact_indices``.

Reinterpret f32 as uint32 and flip (sign ? all : top) bits; float order
then equals unsigned order.  −0.0 is canonicalised to +0.0 first so float
ties and key ties agree.  torch's ``uint32`` lacks most CPU ops, so a key
travels as an int64 holding the uint32 value.  The CUDA kernels compute
the same keys in registers (``csrc/fier_common.cuh``).

``fier_topk_threshold`` takes masked f32 scores [R, S] and returns τ, the
budget-th largest score, and m, the count strictly greater.  On a CUDA
tensor it launches ``csrc/fier_topk.cu`` (K1's radix-256 passes over the
row in device memory); on a CPU tensor it runs
:func:`fier_topk_threshold_plain`, a sort.  The index set
{ s > τ } ∪ the first (budget − m) ties is :func:`compact_indices`, plain
torch as the reference leaves it to jnp.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.obs.flopcount import kernel_leaf

from . import build

launches = 0  # K7 kernel launches since the last reset (the chip check reads it)

_U32 = 0xFFFFFFFF
_TOP = 0x80000000


def _canon(s: torch.Tensor) -> torch.Tensor:
    """Collapse -0.0 → +0.0 so key order and float ties agree."""
    return torch.where(s == 0.0, torch.zeros_like(s), s)


def _sortable_keys(s: torch.Tensor) -> torch.Tensor:
    """f32 → uint32 keys (as int64) such that float order == integer order."""
    u = _canon(s.to(torch.float32)).view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >> 31 == 0, u | _TOP, ~u & _U32)


def _unsortable(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_sortable_keys`: int64 keys → f32."""
    u = torch.where(key >> 31 == 1, key ^ _TOP, ~key & _U32)
    u = torch.where(u >= 2**31, u - 2**32, u)  # uint32 bits as int32
    return u.to(torch.int32).view(torch.float32)


def fier_topk_threshold_plain(scores: torch.Tensor, budget: int):
    """The plain PyTorch version of K7 (same arguments as
    :func:`fier_topk_threshold`): a descending sort of the keys."""
    keys = _sortable_keys(scores)
    tau_key = torch.sort(keys, dim=-1, descending=True).values[:, budget - 1]
    m = (keys > tau_key[:, None]).sum(dim=-1).to(torch.int32)
    return _unsortable(tau_key), m


def compact_indices(
    scores: torch.Tensor, tau: torch.Tensor, m: torch.Tensor, budget: int
) -> torch.Tensor:
    """Sort-free compaction: scores [R, S], tau/m [R] → idx int32 [R, budget].

    Strictly-greater positions land at their running count − 1 (ascending
    position), the first (budget − m) τ-ties fill the tail: one cumsum and
    one bounded scatter, the reference's ``compact_indices``.
    """
    R, S = scores.shape
    s = _canon(scores.to(torch.float32))
    gt = s > tau[:, None]
    tie = s == tau[:, None]
    m = m.to(torch.int64)
    cgt = torch.cumsum(gt, dim=-1)
    ctie = torch.cumsum(tie, dim=-1)
    take_tie = tie & (ctie <= (budget - m)[:, None])
    dest = torch.where(
        gt, cgt - 1,
        torch.where(take_tie, m[:, None] + ctie - 1, torch.full_like(cgt, budget)),
    )
    pos = torch.arange(S, dtype=torch.int32, device=scores.device).expand(R, S)
    out = torch.zeros((R, budget + 1), dtype=torch.int32, device=scores.device)
    out.scatter_(1, dest, pos)  # column `budget` collects the dropped entries
    return out[:, :budget]


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_topk").fier_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@kernel_leaf
def fier_topk_threshold(scores: torch.Tensor, budget: int):
    """Threshold search.  scores f32 [R, S] (masked) → (tau f32 [R],
    m int32 [R]): the budget-th largest score per row (−0.0 as +0.0) and
    the count strictly greater."""
    global launches
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be f32 [R,S], got {scores.dtype} {tuple(scores.shape)}")
    R, S = scores.shape
    if not 0 < budget <= S:
        raise ValueError(f"budget {budget} must be in (0, S={S}]")
    dev = scores.device
    if dev.type == "cpu":
        return fier_topk_threshold_plain(scores, budget)
    if dev.type != "cuda":
        raise ValueError(f"fier_topk_threshold runs on cuda or cpu, not {dev}")
    scores = scores.contiguous()
    tau = torch.empty((R,), dtype=torch.float32, device=dev)
    m = torch.empty((R,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(scores.data_ptr(), tau.data_ptr(), m.data_ptr(), R, S, budget, stream)
    if err != 0:
        raise RuntimeError(f"fier_topk_threshold kernel launch failed: cudaError {err}")
    launches += 1
    return tau, m
