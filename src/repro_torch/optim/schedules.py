"""LR schedules, the port of ``repro.optim.schedules``: cosine and WSD
(warmup-stable-decay, MiniCPM's).  Each takes the step (an int or an int
tensor) and returns the rate as an f32 tensor, computed in f32."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(step, *, peak_lr, warmup, total, final_frac=0.1) -> torch.Tensor:
    s = _f32(step)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return torch.where(s < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr, warmup, total, decay_frac=0.1,
                 final_frac=0.01) -> torch.Tensor:
    """Warmup → stable plateau → sharp exponential-ish decay tail
    (arXiv:2404.06395 §4); ``decay_frac`` is the tail's share of ``total``."""
    s = _f32(step)
    decay_steps = decay_frac * total
    decay_start = total - decay_steps
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - decay_start) / max(decay_steps, 1), 0.0, 1.0)
    decay = peak_lr * torch.pow(torch.tensor(final_frac, device=s.device), prog)
    out = torch.where(s < warmup, warm, torch.full_like(s, peak_lr))
    return torch.where(s > decay_start, decay, out)
