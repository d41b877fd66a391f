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
[B, Hkv, rep, S].  On a CUDA tensor it launches ``csrc/fier_score.cu``
in one resident wave (:func:`score_plan`), which scores each 32-token chunk
with the device function K1 uses, so its scores are K1's internal scores
bit for bit; on a CPU tensor it runs :func:`retrieval_scores`, its plain
version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.obs.flopcount import kernel_leaf

from . import build

launches = 0  # K6 kernel launches since the last reset (the chip check reads it)

# the d_heads K6's and K1/K3's CUDA kernels have fixed instantiations for
# (they share the scoring warp), each checked on the card by chip_smoke.py
# phase 2 (16: every reduced config; 32: reduced zamba2-7b and the examples'
# bench model; 64: granite-moe, minicpm, whisper-small; 112: zamba2-7b; 128:
# the rest), at any rep up to KERNEL_MAX_REP.  Every other d_head that is a
# multiple of 8 up to MAX_HEAD_DIM, and every rep above, runs the generic
# instantiation of its layout class (csrc/fier_common.cuh: any_class).
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128)
KERNEL_MAX_REP = 16
MAX_HEAD_DIM = 256
# query-head floats the generic instantiation stages at once (kAnyQFloats)
ANY_Q_FLOATS = 4096


def check_head_dim(d_head: int) -> None:
    """Raise for a d_head that no CUDA kernel of the port takes: one that is
    not a multiple of 8 from 8 to 256 (the plain versions on the CPU take
    any).  K2/K4/K8 copy a row in 16-byte pieces of 8 channels, and the
    scoring warp's lane words (1, 2 or 4 channels) stay aligned only when a
    head's channels start at a multiple of 8."""
    if d_head % 8 or not 8 <= d_head <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take a d_head that is a multiple of 8 from 8 to "
                         f"{MAX_HEAD_DIM}, got {d_head}: a row is copied 8 channels (16 bytes) "
                         f"at a time and the scoring warp's lane loads must stay aligned")


def fixed_shape(d_head: int, rep: int) -> bool:
    """Whether (d_head, rep) runs on a fixed instantiation of K1/K3 and K6
    (``fixed_shape`` in ``csrc/fier_common.cuh``); else the generic one."""
    return d_head in KERNEL_HEAD_DIMS and 1 <= rep <= KERNEL_MAX_REP


def check_kernel_shape(d_head: int, rep: int) -> None:
    """Raise for a (d_head, rep) that the CUDA kernels of K1/K3 and K6 do
    not take (the plain versions on the CPU take any)."""
    check_head_dim(d_head)
    if rep < 1:
        raise ValueError(f"rep must be at least 1 query head per kv head, got {rep}")


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


class ScorePlan(NamedTuple):
    """How the CUDA kernel spreads the rows' chunks over the SMs."""

    parts: int  # runs of chunks each row is split into
    part_chunks: int  # 32-token chunks of each run (the last may be shorter)
    grid: int  # CTAs, one per SM at most: each walks units grid apart

    def ranges(self, S: int) -> list[tuple[int, int]]:
        """The token range [t0, t1) of each part of a row, in order."""
        T = self.part_chunks * 32
        return [(min(p * T, S), min((p + 1) * T, S)) for p in range(self.parts)]


def score_plan(S: int, rows: int, n_sm: int) -> ScorePlan:
    """The split of ``rows`` score rows of S tokens on a card of ``n_sm``
    SMs: each row into as many equal runs of chunks as one CTA per SM
    allows (at least one run, at most one chunk each), and a grid of at
    most ``n_sm`` CTAs, so every CTA is resident at once; with more rows
    than SMs, a CTA scores several (row, run) units in turn."""
    chunks = -(-S // 32)
    parts = min(max(1, n_sm // rows), chunks)
    part_chunks = -(-chunks // parts)
    parts = -(-chunks // part_chunks)  # no empty run
    return ScorePlan(parts, part_chunks, min(rows * parts, n_sm))


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fier_score").fier_score_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    check_kernel_shape(D, rep)
    n_sm = build.sm_count(dev)
    plan = score_plan(S, B * Hkv, n_sm)
    q = q.to(torch.bfloat16).contiguous()
    codes, scale, zero = codes.contiguous(), scale.contiguous(), zero.contiguous()
    out = torch.empty((B, Hkv, rep, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        B, S, Hkv, rep, D, group, plan.parts, plan.part_chunks, plan.grid, stream,
    )
    if err != 0:
        raise RuntimeError(f"fier_score_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out
