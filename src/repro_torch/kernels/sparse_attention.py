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

On a CUDA tensor ``fier_attend_selected`` launches
``csrc/fier_attend.cu`` (a tiled partial pass plus a small combine, one
C call); on a CPU tensor it runs :func:`fier_attend_selected_plain`.

Given a ``block_table`` [B, n_btab], ``fier_attend_selected`` is K4: it
reads the selected rows from the K/V block pools [N, bs, Hkv, D] through
the table — the same CUDA kernels, with logical index t read at pool row
(table[b, t // bs], t % bs), so its output is K2's bit for bit on the
table-gathered contents.  Its plain version,
:func:`fier_attend_selected_paged_plain`, gathers the pools and runs K2's.

``fier_attend_gathered`` is K8: the rows arrive gathered already
(k_sel/v_sel [B, budget, Hkv, D], what ``gather_kv`` returns) with an int8
validity mask [B, Hkv, budget].  It runs K2's kernels with a third address
policy, so K8 on ``gather_kv(K, V, idx)`` and ``idx < length`` equals K2 on
(K, V, idx, length) bit for bit.  Its plain version,
:func:`fier_attend_gathered_plain`, is the softmax K2's plain version
runs after its gather.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.retrieval import NEG_INF, gather_kv
from repro_torch.kvcache.paged import gather_block_rows
from repro_torch.obs.flopcount import kernel_leaf

from . import build

launches = 0  # K2 kernel launches since the last reset (the chip check reads it)
launches_paged = 0  # K4 kernel launches since the last reset
launches_gathered = 0  # K8 kernel launches since the last reset

TILE = 64  # selected rows per block of the partial pass (kTile in the .cu)
# the one d_head the card has checked the kernel at (chip_smoke.py phase 2);
# a slice that brings another adds it to the .cu and to that phase
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8


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


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_attend").fier_attend_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@kernel_leaf
def fier_attend_selected(q, K, V, idx, lengths=None, *, block_table=None) -> torch.Tensor:
    """Fused select-and-attend.

    q [B, Hkv, rep, D]; K/V bf16 [B, S, Hkv, D]; idx int32 [B, Hkv, budget];
    lengths int32 [B] or None (all valid) → out f32 [B, Hkv, rep, D].

    With ``block_table`` int32 [B, n_btab] (entries < N) K/V are pools
    [N, bs, Hkv, D], S = n_btab · bs, and idx holds logical positions (K4).
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
    if K.dtype != torch.bfloat16 or V.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 K/V, got {K.dtype}, {V.dtype}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    if rep > KERNEL_MAX_REP:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_REP} query "
                         f"heads per kv head, got {rep}")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    q = q.to(torch.float32).contiguous()
    K, V, idx = K.contiguous(), V.contiguous(), idx.contiguous()
    table = block_table.contiguous() if paged else None
    lengths = lengths.to(torch.int32).contiguous()
    n_tiles = -(-budget // TILE)
    part_o = torch.empty((B * Hkv, n_tiles, rep, D), dtype=torch.float32, device=dev)
    part_md = torch.empty((B * Hkv, n_tiles, rep, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), K.data_ptr(), V.data_ptr(), table.data_ptr() if paged else None,
        idx.data_ptr(), lengths.data_ptr(), part_o.data_ptr(), part_md.data_ptr(),
        out.data_ptr(), B, S, bs, Hkv, rep, D, budget, 1.0 / (D ** 0.5), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_attend_selected kernel launch failed: cudaError {err}")
    if paged:
        launches_paged += 1
    else:
        launches += 1
    return out


_fn_gathered = None


def _strided_rows_ok(k_sel, v_sel) -> bool:
    """K8 reads k_sel/v_sel in place: equal strides, contiguous channels,
    every stride a multiple of 8 elements and 16-byte aligned data."""
    st = k_sel.stride()
    return (st == v_sel.stride() and st[3] == 1 and all(x % 8 == 0 for x in st[:3])
            and k_sel.data_ptr() % 16 == 0 and v_sel.data_ptr() % 16 == 0)


def _kernel_gathered():
    global _fn_gathered
    if _fn_gathered is None:
        fn = build.load("fier_attend").fier_attend_gathered_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn_gathered = fn
    return _fn_gathered


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
    if k_sel.dtype != torch.bfloat16 or v_sel.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 rows, got {k_sel.dtype}, {v_sel.dtype}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    if rep > KERNEL_MAX_REP:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_REP} query "
                         f"heads per kv head, got {rep}")
    q = q.to(torch.float32).contiguous()
    # the kernel reads rows through the strides (gather_kv returns a
    # transposed view); other layouts are copied once
    if not _strided_rows_ok(k_sel, v_sel):
        k_sel, v_sel = k_sel.contiguous(), v_sel.contiguous()
    if mask.dtype != torch.int8:
        mask = (mask != 0).to(torch.int8)
    mask = mask.contiguous()
    n_tiles = -(-budget // TILE)
    part_o = torch.empty((B * Hkv, n_tiles, rep, D), dtype=torch.float32, device=dev)
    part_md = torch.empty((B * Hkv, n_tiles, rep, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_gathered()(
        q.data_ptr(), k_sel.data_ptr(), v_sel.data_ptr(), mask.data_ptr(), part_o.data_ptr(),
        part_md.data_ptr(), out.data_ptr(), B, budget, Hkv, rep, D, *k_sel.stride()[:3],
        1.0 / (D ** 0.5), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_attend_gathered kernel launch failed: cudaError {err}")
    launches_gathered += 1
    return out
