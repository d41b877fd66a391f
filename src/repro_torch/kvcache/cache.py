"""KV-cache slabs and append primitives (port of ``repro.kvcache.cache``).

Caches are dicts of stacked tensors [L, B, S, Hkv, D] bf16 (+ the FIER
side-car).  Unlike the JAX package, whose arrays are immutable, the port
updates a cache in place: an append writes one row of the slab and one
group (FIER) or page (Quest) of the side-car, and never copies a slab.  Positions beyond
``length`` hold garbage that every consumer masks.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.core.quantize import QuantizedKeys
from repro_torch.core.quest import PageMeta


def _check_capacity(capacity: int, group: int, *, what: str = "capacity") -> None:
    """FIER side-car layout constraints: 8 tokens/byte and ``group`` tokens
    per (scale, zero) cell (``group`` 0 checks the byte packing only)."""
    if capacity <= 0:
        raise ValueError(f"{what} must be positive, got {capacity}")
    if capacity % 8:
        raise ValueError(f"{what} {capacity} not divisible by 8 (bit packing)")
    if group and capacity % group:
        raise ValueError(f"{what} {capacity} not divisible by group {group}")


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
    """Stacked [L, B, S, Hkv, D] K/V slabs (+ the fier side-car or the
    quest page metadata)."""
    if cfg is not None and cfg.kind == "fier":
        _check_capacity(capacity, cfg.group)
    elif cfg is not None and cfg.kind == "quest" and capacity % cfg.page:
        raise ValueError(f"capacity {capacity} not divisible by quest page {cfg.page}")
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
    elif cfg is not None and cfg.kind == "quest":
        L = cfg.page
        pages = lambda: torch.zeros(
            (n_layers, B, capacity // L, n_kv, d_head), dtype=torch.bfloat16, device=device
        )
        kv["meta"] = PageMeta(pages(), pages(), L)
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


def _put_rows(t: torch.Tensor, index: tuple, new: torch.Tensor, ok: torch.Tensor | None) -> None:
    """``t[index] = new`` on the committing rows (batch axis 0 of ``new``);
    the rows ``ok`` leaves False keep their old values."""
    if ok is not None:
        new = torch.where(ok.reshape(-1, *([1] * (new.dim() - 1))), new, t[index])
    t[index] = new


def append_token_metadata(
    meta: Any,
    k_slab: torch.Tensor,
    length: torch.Tensor,
    cfg: PolicyConfig,
    commit_mask: torch.Tensor | None = None,
) -> Any:
    """Refresh, in place, the side-car block (FIER group / Quest page) that
    holds position ``length`` of each sequence after a 1-token append (each
    sequence may sit in a different block; the start is clamped to
    [0, S-block], as ``dynamic_slice`` clamps it).  Only that block is
    recomputed from the slab.  With ``commit_mask`` [B] bool, the rows it
    leaves False keep their old block."""
    if meta is None or cfg.kind == "full":
        return meta
    if cfg.kind not in ("fier", "quest"):
        raise ValueError(cfg.kind)
    n = cfg.group if cfg.kind == "fier" else cfg.page
    B, S = k_slab.shape[:2]
    dev = k_slab.device
    start = torch.clamp((length.to(torch.int64) // n) * n, 0, S - n)
    rows = torch.arange(B, device=dev)[:, None]
    blk = k_slab[rows, start[:, None] + torch.arange(n, device=dev)[None, :]]  # [B,n,H,D]
    kmax, kmin = blk.amax(dim=1), blk.amin(dim=1)
    cell = start // n
    if cfg.kind == "quest":
        for t, val in ((meta.kmax, kmax), (meta.kmin, kmin)):
            _put_rows(t, (rows[:, 0], cell), val.to(t.dtype), commit_mask)
        return meta
    # Bit for bit as repro/kvcache/cache.py:128-130: midpoint and half-range
    # in the slab dtype (bf16 add, rounded, then the exact halving), and the
    # sign test against that bf16 midpoint.
    g = n
    z, s = (kmax + kmin) * 0.5, (kmax - kmin) * 0.5
    bits = (blk >= z[:, None].to(blk.dtype)).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev).reshape(1, 1, 8, 1, 1)
    packed = (bits.reshape(B, g // 8, 8, *bits.shape[2:]) << shifts).sum(dim=2)
    crow = (start // 8)[:, None] + torch.arange(g // 8, device=dev)[None, :]
    _put_rows(meta.codes, (rows, crow), packed.to(torch.uint8), commit_mask)
    _put_rows(meta.scale, (rows[:, 0], cell), s.to(meta.scale.dtype), commit_mask)
    _put_rows(meta.zero, (rows[:, 0], cell), z.to(meta.zero.dtype), commit_mask)
    return meta


def valid_mask(capacity: int, length: torch.Tensor) -> torch.Tensor:
    """bool[B, capacity] — True for written slots."""
    pos = torch.arange(capacity, dtype=torch.int32, device=length.device)
    return pos[None, :] < length[:, None]
