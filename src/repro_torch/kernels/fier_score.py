"""The per-token score expression of the FIER retrieval kernels
(``repro.kernels.fier_score.score_block``), as plain PyTorch.

The dequantized key ``a = ±1·scale + zero`` is rounded to bf16 (reference
``fier_score.py:68``), then ``q·aᵀ`` is taken with bf16-valued operands and
f32 accumulation.  The products are formed in f32 from the bf16 values —
never by a bf16 ``matmul``, which would round the result to bf16 — so only
the summation order differs from the reference.  On a card that f32 product
must not run in TF32: torch's matmul default keeps full f32, and
``chip_smoke.py`` turns both TF32 switches off explicitly.
"""
from __future__ import annotations

import torch


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
