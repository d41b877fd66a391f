"""K2: fused select-and-attend — the port of the TPU kernel
``repro.kernels.sparse_attention.fused_sparse_attention_hm`` — K4, its
block-table variant, the port of ``paged_fused_sparse_attention_hm``, and
K8, the unfused attend over pre-gathered rows, the port of
``sparse_attention_hm``.

For each (batch, kv-head) the ``budget`` selected rows are read straight
from the seq-major [B, S, Hkv, D] K/V slabs (no K'/V' copy), and the
``rep`` query heads of the group attend over them: f32 scores at scale
1/√D, slots with idx ≥ length masked, f32 softmax, output
out / max(den, 1e-30) in f32.

On a CUDA tensor ``fier_attend_selected`` launches ``csrc/fier_attend.cuh``'s
kernel (K2's fixed instantiations built as ``csrc/fier_attend.cu``, K4's as
``fier_attend_paged.cu``, K8's as ``fier_attend_gathered.cu``, the generic
layout of all three as ``fier_attend_any.cu``) once: each (b, h) row's
slots are split over a thread-block cluster as :func:`attend_plan` says; in
every CTA, 16 lane groups (32 at D ≤ 64)
stream their slots' K and V rows into shared memory with ``cp.async`` (a
ring of 96 KiB, masked slots never read), each keeping an online softmax
(above rep 8 two lane groups share a slot's rows and keep half the query
heads each); and the cluster's CTAs merge their (max, denominator,
output) through distributed shared memory in rank order.  Only ``out`` is
allocated.  The kernel is bound by bytes:
at the serving shape (B 4, Hkv 16, budget 1024, D 128, lengths
8192/5003/2100/700) it must move 31,211,536 B, 0.00932 ms at 3.35 TB/s.
Every d_head that is a multiple of 8 up to 256 runs at every rep: the
shapes without a fixed instantiation take a generic one (d_head and rep at
run time, 32-lane row groups above d_head 128), each CTA attending for a
block of :func:`head_block` query heads.
On a CPU tensor it runs :func:`fier_attend_selected_plain`.

Given a ``block_table`` [B, n_btab], ``fier_attend_selected`` is K4: it
reads the selected rows from the K/V block pools [N, bs, Hkv, D] through
the table — the same CUDA kernel body, with logical index t read at pool
row (table[b, t // bs], t % bs), so its output is K2's bit for bit on the
table-gathered contents.  Its plain version,
:func:`fier_attend_selected_paged_plain`, gathers the pools and runs K2's.

``fier_attend_gathered`` is K8: the rows arrive gathered already
(k_sel/v_sel [B, budget, Hkv, D], what ``gather_kv`` returns) with an int8
validity mask [B, Hkv, budget].  It runs K2's kernel body with a third
address policy and the same plan, so K8 on ``gather_kv(K, V, idx)`` and
``idx < length`` equals K2 on (K, V, idx, length) bit for bit.  Its plain
version, :func:`fier_attend_gathered_plain`, is the softmax K2's plain
version runs after its gather.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.retrieval import NEG_INF, gather_kv
from repro_torch.kvcache.paged import gather_block_rows
from repro_torch.obs.flopcount import kernel_leaf

from . import build
from .fier_score import check_head_dim

launches = 0  # K2 kernel launches since the last reset (the chip check reads it)
launches_paged = 0  # K4 kernel launches since the last reset
launches_gathered = 0  # K8 kernel launches since the last reset

# the d_heads and the query heads per kv head the CUDA kernel has fixed
# instantiations for (one per pair: KERNEL_REPS at each d_head,
# KERNEL_REPS_AT where a d_head takes fewer), each checked on the card by
# chip_smoke.py phase 2; every other d_head that is a multiple of 8 up to
# 256, at any rep, runs a generic instantiation (head_block)
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128)
KERNEL_REPS = (1, 2, 4, 8, 12, 16)
KERNEL_REPS_AT = {112: (1,)}  # zamba2-7b's shared attention block: 32 kv heads, rep 1
MAX_CLUSTER = 8  # CTAs per (b, h) row: the portable cluster size
# the ring of K and V rows in shared memory: 96 KiB at every (d_head, rep)
# (3 steps deep, 6 where the query heads are split; kRingBytes in the .cu)
RING_BYTES = 98304
MAX_CHUNK = 2048  # slots whose rows (4 bytes each) a CTA holds at once (kMaxChunk)
SMEM_LIMIT = 232448  # shared memory a CTA may use on sm_90


def fixed_shape(d_head: int, rep: int) -> bool:
    """Whether (d_head, rep) has a fixed instantiation (``Fixed`` in
    ``csrc/fier_attend.cuh``); every other shape runs a generic one
    (``csrc/fier_attend_any.cu``)."""
    return d_head in KERNEL_HEAD_DIMS and rep in KERNEL_REPS_AT.get(d_head, KERNEL_REPS)


def head_block(d_head: int, rep: int) -> int:
    """The query heads a CTA attends for (kRep in the .cu): all ``rep`` at
    a fixed instantiation; in a generic one the next power of two ≥ rep, at
    most 16 (8 above d_head 128, whose 32-lane row groups leave no room for
    a head split), the grid taking ceil(rep / block) blocks per row."""
    if fixed_shape(d_head, rep):
        return rep
    return min(1 << (rep - 1).bit_length(), 8 if d_head > 128 else 16)


def row_stride(d_head: int, rep: int) -> int:
    """Floats per query head of a CTA's merge scratch and receive slots
    (kD in the .cu): d_head at a fixed instantiation, else the widest
    d_head of its layout class (64, 128 or 256)."""
    if fixed_shape(d_head, rep):
        return d_head
    return 64 if d_head <= 64 else 128 if d_head <= 128 else 256


def lanes_per_row(d_head: int) -> int:
    """Lanes of a row's lane group (kLPR in the .cu): d_head/8, each lane
    copying 8 channels (16 bytes), rounded up to a power of two and at
    least 8 (at 112 a row's 14 chunks take a 16-lane group, two lanes idle;
    at 32 and 16 its 4 or 2 chunks take an 8-lane group, as at 64; above 128
    a 32-lane group)."""
    return 8 if d_head <= 64 else 16 if d_head <= 128 else 32


def step(d_head: int, rep: int) -> int:
    """Slots a CTA takes per step (kStep in the .cu): a row takes
    :func:`lanes_per_row` lanes, so 256 threads hold 32 lane groups at d_head
    ≤ 64, 16 up to 128 and 8 above; above 8 query heads a CTA (its
    :func:`head_block`) two lane groups share a slot's rows (each keeps half
    the query heads); 4 slots per slot group and step.  64 at d_head 128 up
    to rep 8."""
    return 4 * (256 // lanes_per_row(d_head)) // (2 if head_block(d_head, rep) > 8 else 1)


class AttendPlan(NamedTuple):
    """How the CUDA kernel splits each (batch, kv-head) row's slots."""

    cluster: int  # CTAs per row, one thread-block cluster
    chunk: int  # slots whose rows a CTA finds at once (its whole range below MAX_CHUNK)
    smem_bytes: int  # shared memory of each CTA: the ring, rank 0's receive slots, the rows

    def ranges(self, budget: int) -> list[tuple[int, int]]:
        """The slot range [s0, s1) of each CTA, in rank order (as the .cu
        computes it)."""
        C = self.cluster
        return [(r * budget // C, (r + 1) * budget // C) for r in range(C)]


def attend_plan(budget: int, rows: int, n_sm: int, rep: int, d_head: int) -> AttendPlan:
    """The split of ``budget`` slots for ``rows`` = B·Hkv rows on a card of
    ``n_sm`` SMs, for ``rep`` query heads per kv head of ``d_head``.

    C, the CTAs per row, is the largest power of two (≤ 8) whose grid
    ``rows·blocks·C`` (blocks: the row's blocks of :func:`head_block`
    query heads, 1 at a fixed instantiation) still runs in one wave of one
    CTA per SM and whose CTAs each get at least one whole step
    (:func:`step` slots).  Two CTAs per SM
    (they would fit: the 96 KiB ring and at most 8 KiB of rows each, at
    rep ≤ 8) were measured slower:
    clusters of them were not all placed in one wave (PERF.md).  A CTA finds
    the rows of up to ``MAX_CHUNK`` slots at once (its whole range unless
    the budget is very large).  ``rep`` selects the kernel's instantiation
    and, with ``d_head``, sizes rank 0's receive slots (C·block·
    :func:`row_stride`·4 bytes, then 8 per head) and the step.  The
    plan never depends on where the rows are found (slab, pool or
    gathered), so K2, K4 and K8 split a row alike and give equal outputs
    bit for bit."""
    check_kernel_shape(d_head, rep)
    if budget <= 0 or rows <= 0 or n_sm <= 0:
        raise ValueError(f"budget {budget}, rows {rows} and n_sm {n_sm} must be positive")
    block = head_block(d_head, rep)
    units = rows * -(-rep // block)
    c = 1
    while c < MAX_CLUSTER and units * 2 * c <= n_sm and budget >= 2 * c * step(d_head, rep):
        c *= 2
    chunk = min(-(-budget // c), MAX_CHUNK)
    recv = c * block * (row_stride(d_head, rep) + 2) * 4  # each rank's output and (max, den)
    return AttendPlan(c, chunk, RING_BYTES + recv + 4 * chunk)


def _valid(idx: torch.Tensor, lengths: torch.Tensor | None) -> torch.Tensor:
    if lengths is None:
        return torch.ones_like(idx, dtype=torch.bool)
    return idx < lengths.to(idx.dtype)[:, None, None]


def fier_attend_gathered_plain(q, k_sel, v_sel, mask) -> torch.Tensor:
    """The plain PyTorch version of K8 (same arguments as
    :func:`fier_attend_gathered`): an explicit f32 softmax over the gathered
    rows, masked as ``_softmax_accumulate`` masks (one block)."""
    D = q.shape[-1]
    s = torch.einsum(
        "bhrd,bkhd->bhrk", q.to(torch.float32), k_sel.to(torch.float32)
    ) * (1.0 / (D ** 0.5))
    valid = (mask != 0)[:, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhrk,bkhd->bhrd", p, v_sel.to(torch.float32))
    den = p.sum(dim=-1, keepdim=True)
    return out / torch.clamp(den, min=1e-30)


def fier_attend_selected_plain(q, K, V, idx, lengths=None) -> torch.Tensor:
    """The plain PyTorch version of K2: ``gather_kv``, then K8's plain
    version with the mask idx < length."""
    Ksel, Vsel = gather_kv(K, V, idx)  # [B, budget, Hkv, D]
    return fier_attend_gathered_plain(q, Ksel, Vsel, _valid(idx, lengths))


def fier_attend_selected_paged_plain(q, k_pool, v_pool, block_table, idx, lengths=None):
    """The plain PyTorch version of K4 (``fier_attend_selected`` with a
    ``block_table``): ``gather_block_rows`` on K and V, then
    :func:`fier_attend_selected_plain`."""
    return fier_attend_selected_plain(
        q, gather_block_rows(k_pool, block_table), gather_block_rows(v_pool, block_table),
        idx, lengths,
    )


def _check(q, K, V, block_table, idx, lengths):
    """Shapes of one call; returns (B, Hkv, rep, D, S, bs, budget) where S is
    the logical row length and bs the rows per leading entry of K/V (a pool
    block when paged, the whole row otherwise)."""
    paged = block_table is not None
    lead = "N" if paged else "B"
    if q.dim() != 4 or K.dim() != 4 or (paged and block_table.dim() != 2):
        raise ValueError(f"q must be [B,Hkv,rep,D], K/V [{lead},S,Hkv,D]"
                         f"{', block_table [B,n_btab]' if paged else ''}; got "
                         f"{tuple(q.shape)}, {tuple(K.shape)}")
    B, Hkv, rep, D = q.shape
    N, bs = K.shape[:2]
    if paged:
        if block_table.shape[0] != B or block_table.dtype != torch.int32:
            raise ValueError(f"block_table must be int32 [{B},n_btab], got "
                             f"{block_table.dtype} {tuple(block_table.shape)}")
    elif N != B:
        raise ValueError(f"K/V must have {B} rows, got {tuple(K.shape)}")
    if tuple(K.shape) != (N, bs, Hkv, D) or tuple(V.shape) != (N, bs, Hkv, D):
        raise ValueError(f"K/V must be [{lead},S,{Hkv},{D}], got {tuple(K.shape)}, "
                         f"{tuple(V.shape)}")
    if idx.dim() != 3 or tuple(idx.shape[:2]) != (B, Hkv) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 [{B},{Hkv},budget], got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if lengths is not None and tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    ops = (q, K, V, idx) + ((lengths,) if lengths is not None else ())
    devs = {t.device for t in ops + ((block_table,) if paged else ())}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    S = block_table.shape[1] * bs if paged else bs
    return B, Hkv, rep, D, S, bs, idx.shape[2]


def check_kernel_shape(d_head: int, rep: int) -> None:
    """Raise for a (d_head, rep) the CUDA kernel does not take: a d_head
    that is not a multiple of 8 from 8 to 256, or rep below 1."""
    check_head_dim(d_head)
    if rep < 1:
        raise ValueError(f"rep must be at least 1 query head per kv head, got {rep}")


def check_kernel_operands(q, K, V) -> None:
    """What the CUDA kernel admits beyond the shapes (a CUDA tensor outside
    it raises; the plain version on the CPU takes any)."""
    if K.dtype != torch.bfloat16 or V.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 K/V, got {K.dtype}, {V.dtype}")
    check_kernel_shape(q.shape[3], q.shape[2])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data is not 16-byte aligned (the kernel reads q
    16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _plan(dev, rows: int, budget: int, rep: int, d_head: int) -> AttendPlan:
    n_sm = build.sm_count(dev)
    return attend_plan(budget, rows, n_sm, rep, d_head)


_fns = {}  # (library, entry point) -> its launch function
_SLAB_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_GATHERED_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                  + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _kernel(d_head: int = 128, rep: int = 1, rows: str = "slab"):
    """The launch function for (d_head, rep) and where the rows are found
    (``rows``: "slab" K2, "paged" K4, "gathered" K8): the fixed
    instantiations' library of that kernel (``csrc/fier_attend.cu``,
    ``fier_attend_paged.cu``, ``fier_attend_gathered.cu``) or the generic
    layout's (``csrc/fier_attend_any.cu``, whose entry point takes slab and
    pool alike)."""
    if fixed_shape(d_head, rep):
        lib = "fier_attend" if rows == "slab" else f"fier_attend_{rows}"
        name = f"{lib}_launch"
    else:
        lib = "fier_attend_any"
        name = "fier_attend_any_gathered_launch" if rows == "gathered" else "fier_attend_any_launch"
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = _GATHERED_ARGS if rows == "gathered" else _SLAB_ARGS
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn


@kernel_leaf
def fier_attend_selected(q, K, V, idx, lengths=None, *, block_table=None,
                         plan_rows: int | None = None) -> torch.Tensor:
    """Fused select-and-attend.

    q [B, Hkv, rep, D]; K/V bf16 [B, S, Hkv, D]; idx int32 [B, Hkv, budget];
    lengths int32 [B] or None (all valid) → out f32 [B, Hkv, rep, D].

    With ``block_table`` int32 [B, n_btab] (entries < N) K/V are pools
    [N, bs, Hkv, D], S = n_btab · bs, and idx holds logical positions (K4).

    The split is sized for ``plan_rows`` rows when given (a mesh shard
    passes the unsharded call's B·Hkv, so its partial softmax sums in the
    unsharded order), else for this call's B·Hkv.
    """
    global launches, launches_paged
    paged = block_table is not None
    B, Hkv, rep, D, S, bs, budget = _check(q, K, V, block_table, idx, lengths)
    dev = q.device
    if dev.type == "cpu":
        if paged:
            return fier_attend_selected_paged_plain(q, K, V, block_table, idx, lengths)
        return fier_attend_selected_plain(q, K, V, idx, lengths)
    if dev.type != "cuda":
        raise ValueError(f"fier_attend_selected runs on cuda or cpu, not {dev}")
    check_kernel_operands(q, K, V)
    plan = _plan(dev, plan_rows or B * Hkv, budget, rep, D)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    q_bf16 = q.dtype == torch.bfloat16  # read as it is; other types go to f32
    q = _aligned((q if q_bf16 else q.to(torch.float32)).contiguous())
    K, V, idx = K.contiguous(), V.contiguous(), idx.contiguous()
    table = block_table.contiguous() if paged else None
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel(D, rep, "paged" if paged else "slab")(
        q.data_ptr(), K.data_ptr(), V.data_ptr(), table.data_ptr() if paged else None,
        idx.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, bs, Hkv, rep, D, budget,
        1.0 / (D ** 0.5), plan.cluster, plan.chunk, int(q_bf16), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_attend_selected kernel launch failed: cudaError {err}")
    if paged:
        launches_paged += 1
    else:
        launches += 1
    return out


def _strided_rows_ok(k_sel, v_sel) -> bool:
    """K8 reads k_sel/v_sel in place: equal strides, contiguous channels,
    every stride a multiple of 8 elements and 16-byte aligned data."""
    st = k_sel.stride()
    return (st == v_sel.stride() and st[3] == 1 and all(x % 8 == 0 for x in st[:3])
            and k_sel.data_ptr() % 16 == 0 and v_sel.data_ptr() % 16 == 0)


@kernel_leaf
def fier_attend_gathered(q, k_sel, v_sel, mask) -> torch.Tensor:
    """Attend over pre-gathered rows.

    q [B, Hkv, rep, D]; k_sel/v_sel bf16 [B, budget, Hkv, D]; mask
    [B, Hkv, budget] (int8 or bool, nonzero = valid) → out f32
    [B, Hkv, rep, D].
    """
    global launches_gathered
    if q.dim() != 4 or k_sel.dim() != 4:
        raise ValueError(f"q must be [B,Hkv,rep,D] and k_sel [B,budget,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k_sel.shape)}")
    B, Hkv, rep, D = q.shape
    budget = k_sel.shape[1]
    if tuple(k_sel.shape) != (B, budget, Hkv, D) or tuple(v_sel.shape) != (B, budget, Hkv, D):
        raise ValueError(f"k_sel/v_sel must be [{B},budget,{Hkv},{D}], got "
                         f"{tuple(k_sel.shape)}, {tuple(v_sel.shape)}")
    if tuple(mask.shape) != (B, Hkv, budget):
        raise ValueError(f"mask must be [{B},{Hkv},{budget}], got {tuple(mask.shape)}")
    devs = {t.device for t in (q, k_sel, v_sel, mask)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = q.device
    if dev.type == "cpu":
        return fier_attend_gathered_plain(q, k_sel, v_sel, mask)
    if dev.type != "cuda":
        raise ValueError(f"fier_attend_gathered runs on cuda or cpu, not {dev}")
    check_kernel_operands(q, k_sel, v_sel)
    plan = _plan(dev, B * Hkv, budget, rep, D)
    q_bf16 = q.dtype == torch.bfloat16  # read as it is; other types go to f32
    q = _aligned((q if q_bf16 else q.to(torch.float32)).contiguous())
    # the kernel reads rows through the strides (gather_kv returns a
    # transposed view); other layouts are copied once
    if not _strided_rows_ok(k_sel, v_sel):
        k_sel, v_sel = k_sel.contiguous(), v_sel.contiguous()
    if mask.dtype != torch.int8:
        mask = (mask != 0).to(torch.int8)
    mask = mask.contiguous()
    out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel(D, rep, "gathered")(
        q.data_ptr(), k_sel.data_ptr(), v_sel.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, budget, Hkv, rep, D, *k_sel.stride()[:3], 1.0 / (D ** 0.5), plan.cluster, plan.chunk,
        int(q_bf16), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_attend_gathered kernel launch failed: cudaError {err}")
    launches_gathered += 1
    return out
