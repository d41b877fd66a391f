"""KV-cache slabs and append primitives (port of ``repro.kvcache.cache``).

Caches are dicts of stacked tensors [L, B, S, Hkv, D] bf16 (+ the FIER
side-car).  Unlike the JAX package, whose arrays are immutable, the port
updates a cache in place: an append writes one row of the slab and one
group of the side-car, and never copies a slab.  Positions beyond
``length`` hold garbage that every consumer masks.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.core.quantize import QuantizedKeys


def _check_capacity(capacity: int, group: int) -> None:
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    if capacity % 8:
        raise ValueError(f"capacity {capacity} not divisible by 8 (bit packing)")
    if capacity % group:
        raise ValueError(f"capacity {capacity} not divisible by group {group}")


def init_layer_cache(
    n_layers: int,
    B: int,
    capacity: int,
    n_kv: int,
    d_head: int,
    cfg: PolicyConfig | None,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Stacked [L, B, S, Hkv, D] K/V slabs (+ the fier side-car)."""
    if cfg is not None and cfg.kind == "fier":
        _check_capacity(capacity, cfg.group)
    shape = (n_layers, B, capacity, n_kv, d_head)
    kv = dict(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
    if cfg is not None and cfg.kind == "fier":
        g = cfg.group
        side = lambda n, dt: torch.zeros(
            (n_layers, B, n, n_kv, d_head), dtype=dt, device=device
        )
        kv["meta"] = QuantizedKeys(
            side(capacity // 8, torch.uint8),
            side(capacity // g, torch.bfloat16),
            side(capacity // g, torch.bfloat16),
            g,
        )
    return kv


def append_kv(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    length: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new tokens at each sequence's own position, in place.

    k_cache [B,S,H,D], k_new [B,T,H,D], length [B].  The start is clamped
    to [0, S-T], as ``dynamic_update_slice`` clamps it in the reference.
    """
    B, S = k_cache.shape[:2]
    T = k_new.shape[1]
    start = torch.clamp(length.to(torch.int64), 0, S - T)
    rows = torch.arange(B, device=k_cache.device)[:, None]
    pos = start[:, None] + torch.arange(T, device=k_cache.device)[None, :]
    k_cache[rows, pos] = k_new.to(k_cache.dtype)
    v_cache[rows, pos] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def append_token_metadata(
    meta: Any, k_slab: torch.Tensor, length: torch.Tensor, cfg: PolicyConfig
) -> Any:
    """Refresh, in place, the side-car group that holds position ``length``
    of each sequence after a 1-token append (each sequence may sit in a
    different group).  Only that group is recomputed from the slab."""
    if meta is None or cfg.kind == "full":
        return meta
    if cfg.kind != "fier":
        raise NotImplementedError(f"metadata for policy {cfg.kind!r} is not ported")
    g = cfg.group
    B, S = k_slab.shape[:2]
    dev = k_slab.device
    start = torch.clamp((length.to(torch.int64) // g) * g, 0, S - g)
    rows = torch.arange(B, device=dev)[:, None]
    blk = k_slab[rows, start[:, None] + torch.arange(g, device=dev)[None, :]]  # [B,g,H,D]
    kmax, kmin = blk.amax(dim=1), blk.amin(dim=1)
    # Bit for bit as repro/kvcache/cache.py:128-130: midpoint and half-range
    # in the slab dtype (bf16 add, rounded, then the exact halving), and the
    # sign test against that bf16 midpoint.
    z, s = (kmax + kmin) * 0.5, (kmax - kmin) * 0.5
    bits = (blk >= z[:, None].to(blk.dtype)).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev).reshape(1, 1, 8, 1, 1)
    packed = (bits.reshape(B, g // 8, 8, *bits.shape[2:]) << shifts).sum(dim=2)
    crow = (start // 8)[:, None] + torch.arange(g // 8, device=dev)[None, :]
    meta.codes[rows, crow] = packed.to(torch.uint8)
    meta.scale[rows[:, 0], start // g] = s.to(meta.scale.dtype)
    meta.zero[rows[:, 0], start // g] = z.to(meta.zero.dtype)
    return meta


def valid_mask(capacity: int, length: torch.Tensor) -> torch.Tensor:
    """bool[B, capacity] — True for written slots."""
    pos = torch.arange(capacity, dtype=torch.int32, device=length.device)
    return pos[None, :] < length[:, None]
