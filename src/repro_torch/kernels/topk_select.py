"""Monotone uint32 keys for threshold selection (``repro.kernels.topk_select``
helpers ``_canon`` / ``_sortable_keys`` / ``_unsortable``).

Reinterpret f32 as uint32 and flip (sign ? all : top) bits; float order
then equals unsigned order.  −0.0 is canonicalised to +0.0 first so float
ties and key ties agree.  torch's ``uint32`` lacks most CPU ops, so a key
travels as an int64 holding the uint32 value.  The CUDA retrieval kernel
computes the same keys in registers (``csrc/fier_retrieve.cu``).
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_TOP = 0x80000000


def _canon(s: torch.Tensor) -> torch.Tensor:
    """Collapse -0.0 → +0.0 so key order and float ties agree."""
    return torch.where(s == 0.0, torch.zeros_like(s), s)


def _sortable_keys(s: torch.Tensor) -> torch.Tensor:
    """f32 → uint32 keys (as int64) such that float order == integer order."""
    u = _canon(s.to(torch.float32)).view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >> 31 == 0, u | _TOP, ~u & _U32)


def _unsortable(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_sortable_keys`: int64 keys → f32."""
    u = torch.where(key >> 31 == 1, key ^ _TOP, ~key & _U32)
    u = torch.where(u >= 2**31, u - 2**32, u)  # uint32 bits as int32
    return u.to(torch.int32).view(torch.float32)
