"""K2: fused select-and-attend — the port of the TPU kernel
``repro.kernels.sparse_attention.fused_sparse_attention_hm``.

For each (batch, kv-head) the ``budget`` selected rows are read straight
from the seq-major [B, S, Hkv, D] K/V slabs (no K'/V' copy), and the
``rep`` query heads of the group attend over them: f32 scores at scale
1/√D, slots with idx ≥ length masked, f32 softmax, output
out / max(den, 1e-30) in f32.

On a CUDA tensor ``fier_attend_selected`` launches
``csrc/fier_attend.cu`` (a tiled partial pass plus a small combine, one
C call); on a CPU tensor it runs :func:`fier_attend_selected_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.retrieval import NEG_INF, gather_kv

from . import build

launches = 0  # kernel launches since the last reset (the chip check reads it)

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


def _check(q, K, V, idx, lengths):
    if q.dim() != 4 or K.dim() != 4:
        raise ValueError(f"q must be [B,Hkv,rep,D], K/V [B,S,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(K.shape)}")
    B, Hkv, rep, D = q.shape
    S = K.shape[1]
    if tuple(K.shape) != (B, S, Hkv, D) or tuple(V.shape) != (B, S, Hkv, D):
        raise ValueError(f"K/V must be [{B},S,{Hkv},{D}], got {tuple(K.shape)}, "
                         f"{tuple(V.shape)}")
    if idx.dim() != 3 or tuple(idx.shape[:2]) != (B, Hkv) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 [{B},{Hkv},budget], got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if lengths is not None and tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    devs = {t.device for t in (q, K, V, idx) + ((lengths,) if lengths is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return B, Hkv, rep, D, S, idx.shape[2]


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_attend").fier_attend_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fier_attend_selected(q, K, V, idx, lengths=None) -> torch.Tensor:
    """Fused select-and-attend.

    q [B, Hkv, rep, D]; K/V bf16 [B, S, Hkv, D]; idx int32 [B, Hkv, budget];
    lengths int32 [B] or None (all valid) → out f32 [B, Hkv, rep, D].
    """
    global launches
    B, Hkv, rep, D, S, budget = _check(q, K, V, idx, lengths)
    dev = q.device
    if dev.type == "cpu":
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
    lengths = lengths.to(torch.int32).contiguous()
    n_tiles = -(-budget // TILE)
    part_o = torch.empty((B * Hkv, n_tiles, rep, D), dtype=torch.float32, device=dev)
    part_md = torch.empty((B * Hkv, n_tiles, rep, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), K.data_ptr(), V.data_ptr(), idx.data_ptr(), lengths.data_ptr(),
        part_o.data_ptr(), part_md.data_ptr(), out.data_ptr(),
        B, S, Hkv, rep, D, budget, 1.0 / (D ** 0.5), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_attend_selected kernel launch failed: cudaError {err}")
    launches += 1
    return out
