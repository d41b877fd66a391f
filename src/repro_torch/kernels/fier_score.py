"""K6: the two-pass score scan — the port of the TPU kernel
``repro.kernels.fier_score.fier_score_hm`` — and the per-token score
expression every FIER retrieval kernel shares (``score_block``).

The dequantized key ``a = ±1·scale + zero`` is rounded to bf16 (reference
``fier_score.py:68``), then ``q·aᵀ`` is taken with bf16-valued operands and
f32 accumulation.  The products are formed in f32 from the bf16 values —
never by a bf16 ``matmul``, which would round the result to bf16 — so only
the summation order differs from the reference.  On a card that f32 product
must not run in TF32: torch's matmul default keeps full f32, and
``chip_smoke.py`` turns both TF32 switches off explicitly.

``fier_score_scan`` reads the seq-major side-car directly (codes
[B, S/8, Hkv, D], scale/zero [B, S/g, Hkv, D]) and writes f32 scores
[B, Hkv, rep, S].  On a CUDA tensor it launches ``csrc/fier_score.cu``,
which scores each 32-token chunk with the device function K1 uses, so its
scores are K1's internal scores bit for bit; on a CPU tensor it runs
:func:`retrieval_scores`, its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.obs.flopcount import kernel_leaf

from . import build

launches = 0  # K6 kernel launches since the last reset (the chip check reads it)

# the one d_head the card has checked the kernel at (chip_smoke.py phase 2)
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 8


def score_block(
    qbf: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    *,
    group: int,
) -> torch.Tensor:
    """Score packed codes against a kv head's query group.

    qbf [..., rep, D] (bf16 values); codes [..., n8, D] uint8;
    scale/zero [..., n8*8/g, D] → f32 [..., rep, n8*8].  Leading dims are
    batch dims (one per (batch, kv-head) row).
    """
    *lead, n8, D = codes.shape
    S = n8 * 8
    # unpack: bit t of byte i is token 8i+t
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes[..., :, None, :] >> shifts[:, None]) & 1
    pm1 = bits.reshape(*lead, S, D).to(torch.bfloat16) * 2.0 - 1.0
    scale_b = scale.to(torch.bfloat16).repeat_interleave(group, dim=-2)
    zero_b = zero.to(torch.bfloat16).repeat_interleave(group, dim=-2)
    a = pm1 * scale_b + zero_b  # dequantized keys, rounded to bf16
    q32 = qbf.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(q32, a.to(torch.float32).transpose(-1, -2))


def retrieval_scores(q, codes, scale, zero, *, group: int) -> torch.Tensor:
    """The plain PyTorch version of K6 (same arguments as
    :func:`fier_score_scan`): per-query-head scores [B, Hkv, rep, S] of the
    ``score_block`` expression over a seq-major side-car."""
    to_hm = lambda a: a.permute(0, 2, 1, 3)  # [B, Hkv, S/x, D]
    return score_block(q, to_hm(codes), to_hm(scale), to_hm(zero), group=group)


def _check(q, codes, scale, zero, group):
    if q.dim() != 4 or codes.dim() != 4:
        raise ValueError(f"q must be [B,Hkv,rep,D] and codes [B,S/8,Hkv,D]; got "
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
    devs = {t.device for t in (q, codes, scale, zero)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return B, Hkv, rep, D, S


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_score").fier_score_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@kernel_leaf
def fier_score_scan(q, codes, scale, zero, *, group: int) -> torch.Tensor:
    """Two-pass score scan.

    q [B, Hkv, rep, D] (rounded to bf16, as the reference kernel does);
    codes uint8 [B, S/8, Hkv, D]; scale/zero bf16 [B, S/g, Hkv, D]
    → scores f32 [B, Hkv, rep, S].
    """
    global launches
    B, Hkv, rep, D, S = _check(q, codes, scale, zero, group)
    dev = q.device
    if dev.type == "cpu":
        return retrieval_scores(q, codes, scale, zero, group=group)
    if dev.type != "cuda":
        raise ValueError(f"fier_score_scan runs on cuda or cpu, not {dev}")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes d_head {KERNEL_HEAD_DIM}, got {D}")
    if rep > KERNEL_MAX_REP:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_REP} query "
                         f"heads per kv head, got {rep}")
    q = q.to(torch.bfloat16).contiguous()
    codes, scale, zero = codes.contiguous(), scale.contiguous(), zero.contiguous()
    out = torch.empty((B, Hkv, rep, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        B, S, Hkv, rep, D, group, stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_score_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out
