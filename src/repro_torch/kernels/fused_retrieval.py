"""K1: one-pass FIER retrieval — the port of the TPU kernel
``repro.kernels.fused_retrieval.fused_retrieve_hm`` — and K3, its
block-table variant, the port of ``paged_fused_retrieve_hm``.

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

Given a ``block_table`` [B, n_btab], ``fier_retrieve`` is K3: it reads the
side-car from a block pool (codes [N, bs/8, Hkv, D], scale/zero
[N, bs/g, Hkv, D]) through the table.  The same CUDA kernel body walks the
table, so K3 returns K1's idx, τ and m on the table-gathered contents bit
for bit.  Its plain version, :func:`fier_retrieve_paged_plain`, gathers the
pool (``gather_block_rows``) and runs K1's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.retrieval import masked_scores, reduce_over_query_group
from repro_torch.kvcache.paged import gather_block_rows
from repro_torch.obs.flopcount import kernel_leaf

from . import build
from .fier_score import retrieval_scores
from .topk_select import compact_indices, fier_topk_threshold_plain

launches = 0  # K1 kernel launches since the last reset (the chip check reads it)
launches_paged = 0  # K3 kernel launches since the last reset

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


def masked_kv(
    s: torch.Tensor, lengths: torch.Tensor, sink: int, recent: int, group_reduce: str
) -> torch.Tensor:
    """Group-reduce per-head scores [B, Hkv, rep, S] and apply the
    guard-rails (``_masked_block_keys``): the f32 kv scores [B, Hkv, S] that
    K1 ranks."""
    B, Hkv, rep, S = s.shape
    kv = reduce_over_query_group(s.reshape(B, Hkv * rep, S), Hkv, group_reduce)
    return masked_scores(kv, lengths.to(torch.int32), sink=sink, recent=recent)


def fier_retrieve_plain(
    q, codes, scale, zero, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
):
    """The plain PyTorch version of K1 (same arguments as
    :func:`fier_retrieve`): K6's, K7's and ``compact_indices``' plain
    versions in a row.  Materialises the scores; the kernel does not."""
    B, Hkv, rep, D = q.shape
    s = retrieval_scores(q, codes, scale, zero, group=group)
    kv = masked_kv(s, lengths, sink, recent, group_reduce).reshape(B * Hkv, -1)
    tau, m = fier_topk_threshold_plain(kv, budget)
    idx = compact_indices(kv, tau, m, budget)
    return idx.reshape(B, Hkv, budget), tau.reshape(B, Hkv), m.reshape(B, Hkv)


def fier_retrieve_paged_plain(
    q, codes, scale, zero, block_table, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
):
    """The plain PyTorch version of K3 (``fier_retrieve`` with a
    ``block_table``): ``gather_block_rows`` on the three side-car leaves,
    then :func:`fier_retrieve_plain`."""
    g = lambda a: gather_block_rows(a, block_table)
    return fier_retrieve_plain(
        q, g(codes), g(scale), g(zero), lengths, budget,
        group=group, group_reduce=group_reduce, sink=sink, recent=recent,
    )


def _check(q, codes, scale, zero, block_table, lengths, budget, group, group_reduce):
    """Shapes of one call; returns (B, Hkv, rep, D, S, bs) where S is the
    logical row length and bs the tokens per leading entry of the side-car
    (a pool block when paged, the whole row otherwise)."""
    paged = block_table is not None
    lead = "N" if paged else "B"
    if q.dim() != 4 or codes.dim() != 4 or (paged and block_table.dim() != 2):
        raise ValueError(f"q must be [B,Hkv,rep,D], codes [{lead},S/8,Hkv,D]"
                         f"{', block_table [B,n_btab]' if paged else ''}; got "
                         f"{tuple(q.shape)}, {tuple(codes.shape)}")
    B, Hkv, rep, D = q.shape
    N, bs = codes.shape[0], codes.shape[1] * 8
    S = block_table.shape[1] * bs if paged else bs
    if group <= 0 or group % 8 or bs % group:
        raise ValueError(f"group {group} must be a multiple of 8 dividing "
                         f"{'block_size' if paged else 'S'}={bs}")
    if paged:
        if block_table.shape[0] != B or block_table.dtype != torch.int32:
            raise ValueError(f"block_table must be int32 [{B},n_btab], got "
                             f"{block_table.dtype} {tuple(block_table.shape)}")
    elif N != B:
        raise ValueError(f"codes must have {B} rows, got {tuple(codes.shape)}")
    if tuple(codes.shape) != (N, bs // 8, Hkv, D) or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 [{N},{bs // 8},{Hkv},{D}], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    for name, a in (("scale", scale), ("zero", zero)):
        if tuple(a.shape) != (N, bs // group, Hkv, D) or a.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 [{N},{bs // group},{Hkv},{D}], "
                             f"got {a.dtype} {tuple(a.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    if not 0 < budget <= S:
        raise ValueError(f"budget {budget} must be in (0, S={S}]")
    if group_reduce not in ("max", "sum"):
        raise ValueError(f"unknown group reduction {group_reduce!r}")
    ops = (q, codes, scale, zero, lengths) + ((block_table,) if paged else ())
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return B, Hkv, rep, D, S, bs


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_retrieve").fier_retrieve_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@kernel_leaf
def fier_retrieve(
    q, codes, scale, zero, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
    block_table=None,
):
    """One-pass retrieval.

    q [B, Hkv, rep, D] (rounded to bf16, as the reference kernel does);
    codes uint8 [B, S/8, Hkv, D]; scale/zero bf16 [B, S/g, Hkv, D];
    lengths int32 [B] → (idx int32 [B, Hkv, budget], tau f32 [B, Hkv],
    m int32 [B, Hkv]).

    With ``block_table`` int32 [B, n_btab] (entries < N; 0 is the null
    block) the side-car is a pool: codes [N, bs/8, Hkv, D], scale/zero
    [N, bs/g, Hkv, D], S = n_btab · bs, and idx holds logical positions (K3).
    """
    global launches, launches_paged
    paged = block_table is not None
    B, Hkv, rep, D, S, bs = _check(
        q, codes, scale, zero, block_table, lengths, budget, group, group_reduce
    )
    sel = dict(group=group, group_reduce=group_reduce, sink=sink, recent=recent)
    dev = q.device
    if dev.type == "cpu":
        if paged:
            return fier_retrieve_paged_plain(
                q, codes, scale, zero, block_table, lengths, budget, **sel
            )
        return fier_retrieve_plain(q, codes, scale, zero, lengths, budget, **sel)
    if dev.type != "cuda":
        raise ValueError(f"fier_retrieve runs on cuda or cpu, not {dev}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    if rep > KERNEL_MAX_REP:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_REP} query "
                         f"heads per kv head, got {rep}")
    n_btab = block_table.shape[1] if paged else 0
    if S + n_btab > MAX_ROW_TOKENS:
        raise ValueError(
            f"S={S} tokens: one row's keys and its {n_btab}-entry block table "
            f"({4 * (S + n_btab)} bytes) do not fit in the {SMEM_LIMIT}-byte shared "
            f"memory of a block (limit {MAX_ROW_TOKENS} words); the long-row "
            f"variant that re-scores per sweep is ROADMAP Queue 2 (K1 long rows)"
        )
    q = q.to(torch.bfloat16).contiguous()
    codes, scale, zero = codes.contiguous(), scale.contiguous(), zero.contiguous()
    table = block_table.contiguous() if paged else None
    lengths = lengths.to(torch.int32).contiguous()
    idx = torch.empty((B, Hkv, budget), dtype=torch.int32, device=dev)
    tau = torch.empty((B, Hkv), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        table.data_ptr() if paged else None, lengths.data_ptr(), idx.data_ptr(),
        tau.data_ptr(), m.data_ptr(), B, S, bs, Hkv, rep, D, group, budget,
        int(group_reduce == "sum"), sink, recent, stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_retrieve kernel launch failed: cudaError {err}")
    if paged:
        launches_paged += 1
    else:
        launches += 1
    return idx, tau, m
