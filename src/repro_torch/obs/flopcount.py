"""Bytes of per-token score tensors that a decode call materialises: the
torch counterpart of ``benchmarks/flopcount.py::count_score_bytes``.

``count_score_bytes(fn, seq_len, *args)`` runs ``fn(*args)`` under a
``TorchDispatchMode`` and sums the output bytes of every op whose output
has a float dtype, at least two dims and a trailing dim equal to
``seq_len`` — the [B, Hq, S] / [B, Hkv, S] score tensors (and their
masked or reduced copies) that the two-pass pipeline writes to memory and
reads back.  Views materialise nothing and are not counted.

A kernel wrapper (decorated with :func:`kernel_leaf`) counts as one op, as
the reference counts a ``pallas_call``: its outputs are counted — K6's
[B, Hkv, rep, S] f32 scores — and nothing that runs inside it.  On a CUDA
tensor that is the kernel's output buffer; on a CPU tensor the wrapper
runs its plain version, whose intermediates stand for what the kernel
keeps in registers and shared memory.  So the one-pass pipeline, whose
kernels return only indices, τ/m and the attention output, counts 0 on
either device.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_FLOAT = (torch.float32, torch.bfloat16, torch.float16)
_active: list["_ScoreBytes"] = []


def _score_bytes(out, seq_len: int) -> int:
    total = 0
    for t in tree_leaves(out):
        if (isinstance(t, torch.Tensor) and t.dim() >= 2 and t.shape[-1] == seq_len
                and t.dtype in _FLOAT):
            total += t.numel() * t.element_size()
    return total


class _ScoreBytes(TorchDispatchMode):
    def __init__(self, seq_len: int):
        super().__init__()
        self.seq_len = seq_len
        self.total = 0
        self.paused = 0  # > 0 inside a kernel wrapper

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and not func.is_view:
            self.total += _score_bytes(out, self.seq_len)
        return out


def kernel_leaf(fn):
    """Mark a kernel wrapper as one op for :func:`count_score_bytes`.
    Outside a count it costs one list check per call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _active:
            return fn(*args, **kwargs)
        mode = _active[-1]
        mode.paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            mode.paused -= 1
        mode.total += _score_bytes(out, mode.seq_len)
        return out

    return wrapper


def count_score_bytes(fn, seq_len: int, *args) -> int:
    """Bytes of materialised ``seq_len``-long score tensors written by
    ``fn(*args)``.  ``seq_len`` must differ from the model's other trailing
    dims; 128 is refused, since every attention output ends in d_head 128.

    The contract the JAX package's benchmarks hold (``benchmarks/common.py``
    ``emit_score_traffic``): ``one_pass`` 0 on both layouts, ``two_pass`` at
    least 2·4·Hq·S·B (the f32 [B, Hq, S] scores written and read back),
    ``reference`` > 0."""
    if seq_len == 128:
        raise ValueError("seq_len 128 collides with d_head; measure at another cache length")
    mode = _ScoreBytes(seq_len)
    _active.append(mode)
    try:
        with mode:
            fn(*args)
    finally:
        _active.pop()
    return mode.total
