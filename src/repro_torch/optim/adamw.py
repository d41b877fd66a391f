"""AdamW with decoupled weight decay and fp32 moments: the port of
``repro.optim.adamw``.  Functional: ``adamw_update`` returns new params and
a new state and leaves its arguments as they were.  Moments are f32
whatever the param dtype, the step counter int32, and the bias corrections
are computed in f32 from the step, as the reference computes them.  Over
a mesh's Sharded leaves every function runs piece by piece, and the
global norm counts each logical element once."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .tree import leaves, map_leaves, pieces


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=map_leaves(zeros, params), nu=map_leaves(zeros, params))


def _sq_sum(g: Any) -> torch.Tensor:
    """Σ g² in f32 over a leaf's logical elements (a Sharded leaf's pieces,
    each once, summed on its first piece's device)."""
    parts = [torch.sum(torch.square(p.to(torch.float32))) for p in pieces(g)]
    return sum(p.to(parts[0].device) for p in parts)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """(grads · min(1, max_norm / ‖grads‖) in f32, ‖grads‖): the norm sums
    the leaves' squares in the reference's leaf order."""
    sq = [_sq_sum(g) for g in leaves(grads)]
    gn = torch.sqrt(sum(s.to(sq[0].device) for s in sq))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_leaves(lambda g: g.to(torch.float32) * scale.to(g.device), grads), gn


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[Any, AdamWState]:
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full((), b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.full((), b2, device=t.device), t)

    def upd(g, m, n, p):
        gf = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * gf
        n2 = b2 * n + (1 - b2) * gf * gf
        delta = (m2 / bc1.to(p.device)) / (torch.sqrt(n2 / bc2.to(p.device)) + eps) \
            + weight_decay * p.to(torch.float32)
        lr_ = lr.to(p.device) if isinstance(lr, torch.Tensor) else lr
        return (p.to(torch.float32) - lr_ * delta).to(p.dtype), m2, n2

    out = map_leaves(upd, grads, state.mu, state.nu, params)
    pick = lambda i: map_leaves(lambda t3: t3[i], out)
    return pick(0), AdamWState(step, pick(1), pick(2))
