"""1-bit group-wise RTN quantization of the key cache (FIER, §3.2/Alg. 1).

Port of ``repro.core.quantize``; same layouts, same arithmetic:

    codes:  uint8[B, S//8, H, D]   sign bits, bit ``t`` of byte ``i`` = token 8i+t
    scale:  bf16 [B, S//g, H, D]   per (seq-group, channel) half-range
    zero:   bf16 [B, S//g, H, D]   per (seq-group, channel) midpoint

Groups are ``g`` consecutive tokens along the sequence within a channel.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedKeys:
    """Packed 1-bit key-cache side-car.  A stacked cache carries a leading
    layer axis on all three tensors; ``group`` is the tokens per
    (scale, zero) cell."""

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    group: int

    FIELDS = ("codes", "scale", "zero")

    @property
    def seq_len(self) -> int:
        return self.codes.shape[-3] * 8

    def layer(self, i: int) -> "QuantizedKeys":
        """The side-car of layer ``i`` of a stacked cache (views, so
        in-place updates reach the stack)."""
        return QuantizedKeys(self.codes[i], self.scale[i], self.zero[i], self.group)


def _check_seq(S: int, group: int) -> None:
    if S % group != 0:
        raise ValueError(f"seq len {S} not divisible by group size {group}")
    if S % 8 != 0:
        raise ValueError(f"seq len {S} not divisible by 8 (bit packing)")
    if group % 8 != 0:
        raise ValueError(f"group size {group} must be a multiple of 8")


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def group_stats(K: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (seq-group, channel) scale & zero: K [B,S,H,D] → [B,S//g,H,D] bf16.

    Midpoint and half-range are computed in K's dtype and then rounded to
    bf16, as ``repro.core.quantize.group_stats`` does."""
    B, S, H, D = K.shape
    Kg = K.reshape(B, S // group, group, H, D)
    kmax = Kg.amax(dim=2)
    kmin = Kg.amin(dim=2)
    zero = (kmax + kmin) * 0.5
    scale = (kmax - kmin) * 0.5
    return scale.to(torch.bfloat16), zero.to(torch.bfloat16)


def sign_bits(K: torch.Tensor, zero: torch.Tensor, group: int) -> torch.Tensor:
    """bit = (K >= z), against the bf16 zero cast back to K's dtype.
    [B, S, H, D] uint8 (unpacked)."""
    z = zero.to(K.dtype).repeat_interleave(group, dim=1)
    return (K >= z).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack seq-major bits [B, S, H, D] → uint8[B, S//8, H, D]."""
    B, S, H, D = bits.shape
    b8 = bits.reshape(B, S // 8, 8, H, D)
    shifts = _shifts(bits.device).reshape(1, 1, 8, 1, 1)
    return (b8 << shifts).sum(dim=2).to(torch.uint8)


def unpack_bits(codes: torch.Tensor) -> torch.Tensor:
    """uint8[B, S//8, H, D] → {0,1} uint8[B, S, H, D]."""
    B, S8, H, D = codes.shape
    shifts = _shifts(codes.device).reshape(1, 1, 8, 1, 1)
    bits = (codes[:, :, None] >> shifts) & 1
    return bits.reshape(B, S8 * 8, H, D)


def quantize(K: torch.Tensor, group: int = 32) -> QuantizedKeys:
    """Full 1-bit group RTN quantization of a key cache slab [B,S,H,D]."""
    _check_seq(K.shape[1], group)
    scale, zero = group_stats(K, group)
    bits = sign_bits(K, zero, group)
    return QuantizedKeys(pack_bits(bits), scale, zero, group)


def dequantize(q: QuantizedKeys) -> torch.Tensor:
    """K̃ = code·s + z ∈ {z−s, z+s}.  Returns bf16 [B, S, H, D]."""
    bits = unpack_bits(q.codes)
    pm1 = bits.to(torch.bfloat16) * 2.0 - 1.0
    s = q.scale.repeat_interleave(q.group, dim=1)
    z = q.zero.repeat_interleave(q.group, dim=1)
    return pm1 * s + z


def packed_nbytes(S: int, H: int, D: int, group: int) -> int:
    """Bytes touched by the score scan per batch element (codes + s/z)."""
    return S // 8 * H * D + 2 * (S // group) * H * D * 2


def load_ratio(group: int) -> float:
    """Paper Eq. 8: key-cache load ratio of the selection pass."""
    return (1.0 + 32.0 / group) / 16.0
