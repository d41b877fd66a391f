"""K2: fused select-and-attend — the port of the TPU kernel
``repro.kernels.sparse_attention.fused_sparse_attention_hm`` — and K4, its
block-table variant, the port of ``paged_fused_sparse_attention_hm``.

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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.retrieval import NEG_INF, gather_kv
from repro_torch.kvcache.paged import gather_block_rows

from . import build

launches = 0  # K2 kernel launches since the last reset (the chip check reads it)
launches_paged = 0  # K4 kernel launches since the last reset

TILE = 64  # selected rows per block of the partial pass (kTile in the .cu)
# the one d_head the card has checked the kernel at (chip_smoke.py phase 2);
# a slice that brings another adds it to the .cu and to that phase
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8


def _valid(idx: torch.Tensor, lengths: torch.Tensor | None) -> torch.Tensor:
    if lengths is None:
        return torch.ones_like(idx, dtype=torch.bool)
    return idx < lengths.to(idx.dtype)[:, None, None]


def fier_attend_selected_plain(q, K, V, idx, lengths=None) -> torch.Tensor:
    """The plain PyTorch version of K2: ``gather_kv`` then an explicit f32
    softmax, masked as ``_softmax_accumulate`` masks (one block)."""
    B, Hkv, rep, D = q.shape
    Ksel, Vsel = gather_kv(K, V, idx)  # [B, budget, Hkv, D]
    s = torch.einsum(
        "bhrd,bkhd->bhrk", q.to(torch.float32), Ksel.to(torch.float32)
    ) * (1.0 / (D ** 0.5))
    valid = _valid(idx, lengths)[:, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhrk,bkhd->bhrd", p, Vsel.to(torch.float32))
    den = p.sum(dim=-1, keepdim=True)
    return out / torch.clamp(den, min=1e-30)


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
