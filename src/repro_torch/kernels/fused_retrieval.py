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
On a CUDA tensor it launches ``csrc/fier_retrieve.cuh``'s kernel, built
as ``csrc/fier_retrieve.cu`` (K1's fixed instantiations; K3's are
``fier_retrieve_paged.cu``'s) or ``csrc/fier_retrieve_any.cu`` (the
generic layout): each row is split
over a thread-block cluster as :func:`retrieval_plan` says, and its scores
and keys live in registers and shared memory — except on the long-row path
(keys of a row beyond what 8 CTAs' shared memory holds, ~379k tokens), where
the keys, 4 bytes per token and kv head, go to a device scratch.  Every
d_head that is a multiple of 8 up to 256 runs at every rep (the shapes
without a fixed instantiation on the generic layout, ``fier_score``).  On
a CPU tensor it runs :func:`fier_retrieve_plain`, the same function in
plain PyTorch.

Given a ``block_table`` [B, n_btab], ``fier_retrieve`` is K3: it reads the
side-car from a block pool (codes [N, bs/8, Hkv, D], scale/zero
[N, bs/g, Hkv, D]) through the table.  The same CUDA kernel body walks the
table, so K3 returns K1's idx, τ and m on the table-gathered contents bit
for bit.  Its plain version, :func:`fier_retrieve_paged_plain`, gathers the
pool (``gather_block_rows``) and runs K1's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.retrieval import masked_scores, reduce_over_query_group
from repro_torch.kvcache.paged import gather_block_rows
from repro_torch.obs.flopcount import kernel_leaf

from . import build
from .fier_score import (  # K1 shares K6's instantiations
    ANY_Q_FLOATS, check_kernel_shape, fixed_shape, retrieval_scores,
)
from .topk_select import compact_indices, fier_topk_threshold_plain

launches = 0  # K1 kernel launches since the last reset (the chip check reads it)
launches_paged = 0  # K3 kernel launches since the last reset

SMEM_LIMIT = 232448  # shared memory a CTA may use on sm_90
MAX_CLUSTER = 8  # CTAs per row: the portable cluster size
# the widest split taken only to fill the SMs: a 512-thread CTA takes a whole
# SM, and clusters of 8 such CTAs did not all fit one wave (PERF.md)
FILL_CLUSTER = 4


def smem_static(d_head: int, rep: int) -> int:
    """The static shared memory of the instantiation taking (d_head, rep),
    as ``smem_static`` in ``csrc/fier_retrieve.cuh`` counts it: q in f32 for
    the query heads it stages (``rep_slots`` in ``csrc/fier_common.cuh``: 8
    at d_head 128 up to rep 8, the serving instantiation, else 16), each of
    16 warps' 2^c × 32 scoring sums (c = ``lane_channels``, the channels a
    lane owns: 1 at d_head 16 and 32, 2 at 64, 4 at 112 and 128), one radix histogram per
    pass and their sum, scan scratch, rounded up to a KiB (43,008 B at
    d_head 128, rep ≤ 8; 46,080 at 112; 12,288 at 32 and 11,264 at 16,
    whose lanes own one channel each).  The generic instantiation (every
    other shape) stages ANY_Q_FLOATS of query heads at a time and has 8
    warps whose lanes own the channels of its layout class: 38,912 B in the
    classes 128 and 256, 26,624 in 64, 24,576 in 32."""
    if fixed_shape(d_head, rep):
        q_floats, warps = (8 if d_head == 128 and rep <= 8 else 16) * d_head, 16
        lane_channels = 1 if d_head <= 32 else 2 if d_head == 64 else 4
    else:
        q_floats, warps = ANY_Q_FLOATS, 8
        lane_channels = 1 if d_head <= 32 else 2 if d_head <= 64 else 4
    floats = q_floats + warps * 32 * 2**lane_channels + 4 * 256 + 256 + warps + 4
    return -(-4 * floats // 1024) * 1024


class RetrievalPlan(NamedTuple):
    """How the CUDA kernel splits each (batch, kv-head) row."""

    cluster: int  # CTAs per row, one thread-block cluster
    cta_tokens: int  # tokens of the row each CTA scores (a multiple of 32)
    smem_keys: bool  # keys in shared memory; False: the long-row path
    smem_bytes: int  # dynamic shared memory of each CTA

    def ranges(self, S: int) -> list[tuple[int, int]]:
        """The token range [t0, t1) of each CTA, in rank order."""
        T = self.cta_tokens
        return [(min(r * T, S), min((r + 1) * T, S)) for r in range(self.cluster)]


def retrieval_plan(S: int, rows: int, n_sm: int, bs: int | None = None, *,
                   d_head: int, rep: int) -> RetrievalPlan:
    """The split of a row of S tokens for ``rows`` = B·Hkv rows on a card of
    ``n_sm`` SMs (``bs``: the pool's block size, for K3's table range), for
    the instantiation taking ``d_head`` and ``rep`` (its static shared
    memory, :func:`smem_static`, is what the keys share a CTA with).

    C, the CTAs per row, is the largest power of two (≤ 4) whose grid
    ``rows·C`` still runs in one wave of one CTA per SM, halved while a CTA
    would get no token, and doubled (up to 8) while a CTA's keys (4 bytes
    each) do not fit its shared memory.  Where even 8 CTAs cannot hold a
    row's keys, the long-row path keeps them in a device scratch
    [rows, C·cta_tokens] instead."""
    static = smem_static(d_head, rep)
    chunks = -(-S // 32)
    tokens = lambda c: -(-chunks // c) * 32
    table = lambda T: 4 * ((T + bs - 1) // bs + 1) if bs else 0
    fits = lambda c: static + 4 * tokens(c) + table(tokens(c)) <= SMEM_LIMIT
    c = 1
    while c < FILL_CLUSTER and rows * 2 * c <= n_sm:
        c *= 2
    while c > 1 and (c - 1) * tokens(c) >= S:
        c //= 2
    while c < MAX_CLUSTER and not fits(c):
        c *= 2
    T = tokens(c)
    smem_keys = fits(c)
    smem = (4 * T if smem_keys else 0) + table(T)
    if static + smem > SMEM_LIMIT:
        raise ValueError(f"S={S}: a CTA's {T}-token range needs {smem} bytes of block "
                         f"table in shared memory, more than {SMEM_LIMIT - static}")
    return RetrievalPlan(c, T, smem_keys, smem)


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


_fns = {}  # library name -> its launch function


def _kernel(name: str = "fier_retrieve"):
    """The launch function of ``csrc/<name>.cu``: "fier_retrieve" and
    "fier_retrieve_paged" (K1's and K3's fixed instantiations) or
    "fier_retrieve_any" (the generic layout of both)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(name), f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@kernel_leaf
def fier_retrieve(
    q, codes, scale, zero, lengths, budget: int, *,
    group: int, group_reduce: str = "max", sink: int = 0, recent: int = 0,
    block_table=None, plan_rows: int | None = None,
):
    """One-pass retrieval.

    q [B, Hkv, rep, D] (rounded to bf16, as the reference kernel does);
    codes uint8 [B, S/8, Hkv, D]; scale/zero bf16 [B, S/g, Hkv, D];
    lengths int32 [B] → (idx int32 [B, Hkv, budget], tau f32 [B, Hkv],
    m int32 [B, Hkv]).

    With ``block_table`` int32 [B, n_btab] (entries < N; 0 is the null
    block) the side-car is a pool: codes [N, bs/8, Hkv, D], scale/zero
    [N, bs/g, Hkv, D], S = n_btab · bs, and idx holds logical positions (K3).

    Any S that the shapes admit runs on the card: rows whose keys do not fit
    8 CTAs' shared memory take the long-row path (:func:`retrieval_plan`).
    The split is sized for ``plan_rows`` rows when given (a mesh shard
    passes the unsharded call's B·Hkv), else for this call's B·Hkv.
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
    check_kernel_shape(D, rep)
    n_sm = build.sm_count(dev)
    plan = retrieval_plan(S, plan_rows or B * Hkv, n_sm, bs if paged else None,
                          d_head=D, rep=rep)
    q = q.to(torch.bfloat16).contiguous()
    codes, scale, zero = codes.contiguous(), scale.contiguous(), zero.contiguous()
    table = block_table.contiguous() if paged else None
    lengths = lengths.to(torch.int32).contiguous()
    idx = torch.empty((B, Hkv, budget), dtype=torch.int32, device=dev)
    tau = torch.empty((B, Hkv), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv), dtype=torch.int32, device=dev)
    keys = None if plan.smem_keys else torch.empty(
        (B * Hkv, plan.cluster * plan.cta_tokens), dtype=torch.int32, device=dev
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = ("fier_retrieve_paged" if paged else "fier_retrieve") if fixed_shape(D, rep) else \
        "fier_retrieve_any"
    err = _kernel(name)(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        table.data_ptr() if paged else None, lengths.data_ptr(), idx.data_ptr(),
        tau.data_ptr(), m.data_ptr(), B, S, bs, Hkv, rep, D, group, budget,
        int(group_reduce == "sum"), sink, recent, plan.cluster, plan.cta_tokens,
        None if keys is None else keys.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_retrieve kernel launch failed: cudaError {err}")
    if paged:
        launches_paged += 1
    else:
        launches += 1
    return idx, tau, m
