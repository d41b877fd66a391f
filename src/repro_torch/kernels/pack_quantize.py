"""K5: 1-bit group quantize and bit-pack of a key slab — the port of the TPU
kernel ``repro.kernels.pack_quantize.pack_quantize_hm``.

Per (group of g tokens, channel): min and max in f32, zero = (max+min)/2
and scale = (max−min)/2 in f32, both stored bf16; bit t of code byte i is
k[8i+t] ≥ the stored zero.  That is the TPU kernel's arithmetic, not
``core/quantize.quantize``'s, which takes the midpoint in the key's dtype
(bf16 on the serving path): the two can differ in the last bf16 place, so
prefill and decode keep building the side-car with ``quantize`` and this
kernel has no serving caller, as in the JAX package (``ops.pack_quantize``
is a building block).

``fier_pack_quantize`` reads the seq-major slab [B, S, Hkv, D] (bf16 or
f32) and writes the seq-major side-car (codes [B, S/8, Hkv, D], scale/zero
[B, S/g, Hkv, D]).  On a CUDA tensor it launches ``csrc/fier_pack.cu``; on
a CPU tensor it runs :func:`fier_pack_quantize_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.obs.flopcount import kernel_leaf

from . import build

launches = 0  # K5 kernel launches since the last reset (the chip check reads it)

# the one d_head the card has checked the kernel at (chip_smoke.py phase 2)
KERNEL_HEAD_DIM = 128


def fier_pack_quantize_plain(k: torch.Tensor, group: int):
    """The plain PyTorch version of K5 (same arguments as
    :func:`fier_pack_quantize`), in f32 as the TPU kernel computes."""
    B, S, H, D = k.shape
    kf = k.to(torch.float32)
    kg = kf.reshape(B, S // group, group, H, D)
    kmax = kg.amax(dim=2)
    kmin = kg.amin(dim=2)
    zero = ((kmax + kmin) * 0.5).to(torch.bfloat16)
    scale = ((kmax - kmin) * 0.5).to(torch.bfloat16)
    zfull = zero.to(torch.float32).repeat_interleave(group, dim=1)
    bits = (kf >= zfull).to(torch.uint8).reshape(B, S // 8, 8, H, D)
    shifts = torch.arange(8, dtype=torch.uint8, device=k.device).reshape(1, 1, 8, 1, 1)
    codes = (bits << shifts).sum(dim=2).to(torch.uint8)
    return codes, scale, zero


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_pack").fier_pack_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@kernel_leaf
def fier_pack_quantize(k: torch.Tensor, group: int):
    """Quantize and pack.  k [B, S, Hkv, D] bf16 or f32 →
    (codes uint8 [B, S/8, Hkv, D], scale bf16 [B, S/g, Hkv, D],
    zero bf16 [B, S/g, Hkv, D])."""
    global launches
    if k.dim() != 4 or k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k must be bf16 or f32 [B,S,Hkv,D], got {k.dtype} {tuple(k.shape)}")
    B, S, H, D = k.shape
    if group <= 0 or group % 8 or S % group:
        raise ValueError(f"group {group} must be a multiple of 8 dividing S={S}")
    dev = k.device
    if dev.type == "cpu":
        return fier_pack_quantize_plain(k, group)
    if dev.type != "cuda":
        raise ValueError(f"fier_pack_quantize runs on cuda or cpu, not {dev}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    k = k.contiguous()
    codes = torch.empty((B, S // 8, H, D), dtype=torch.uint8, device=dev)
    scale = torch.empty((B, S // group, H, D), dtype=torch.bfloat16, device=dev)
    zero = torch.empty((B, S // group, H, D), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        k.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), B, S, H, D, group,
        int(k.dtype == torch.float32), stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_pack_quantize kernel launch failed: cudaError {err}")
    launches += 1
    return codes, scale, zero
