"""train_step / serve_step factories: the port of ``repro.launch.steps``.

The train state is one tree, ``{"params", "opt": AdamWState[, "ef"]}``, so
checkpointing and recovery handle one object.  A step is functional: it
returns a new state and leaves the one it was given as it was.  A bundle
built on a mesh takes a state placed by ``core.placement.place_tree``: the
same step then differentiates its mesh ``train_loss`` piece by piece, and
the optimizer runs per piece (``optim.tree.map_leaves``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.models.transformer import ModelBundle
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_decompress, cosine_schedule, ef_state_init,
                               wsd_schedule)
from repro_torch.optim.tree import map_leaves

_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd (minicpm)
    grad_clip: float = 1.0
    weight_decay: float = 0.1
    compress_grads: bool = False      # 1-bit error feedback
    microbatches: int = 1             # gradient accumulation (memory / step)
    accum_dtype: str = "float32"      # grad accumulator (bf16 for 100B+ cells)


def make_schedule(hp: TrainHParams) -> Callable:
    fn = wsd_schedule if hp.schedule == "wsd" else cosine_schedule
    return partial(fn, peak_lr=hp.peak_lr, warmup=hp.warmup, total=hp.total_steps)


def _loss_and_grads(bundle: ModelBundle, params: dict, batch: dict):
    """(loss, metrics, grads) of ``bundle.train_loss`` at ``params``, all
    detached; a leaf no path reaches gets a zero gradient."""
    leaves = []

    def track(p):
        leaves.append(p.detach().requires_grad_())
        return leaves[-1]

    p_req = map_leaves(track, params)
    loss, metrics = bundle.train_loss(p_req, batch)
    pairs = iter(zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True)))

    def grad_of(_):
        p, g = next(pairs)
        return torch.zeros_like(p) if g is None else g

    grads = map_leaves(grad_of, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(bundle: ModelBundle, hp: TrainHParams) -> Callable:
    """(state, batch) → (state, metrics): the gradient of
    ``bundle.train_loss`` (summed over ``hp.microbatches`` equal slices of
    the batch in ``hp.accum_dtype``, then divided by their number), clipped
    to ``hp.grad_clip``, optionally 1-bit compressed, then one AdamW step at
    the schedule's rate for the optimizer's step count."""
    sched = make_schedule(hp)
    adt = _ACCUM[hp.accum_dtype]

    def train_step(state: dict, batch: dict):
        params, opt = state["params"], state["opt"]
        if hp.microbatches > 1:
            n = hp.microbatches
            acc = map_leaves(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
            losses, ms = [], []
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
                loss_i, m_i, g = _loss_and_grads(bundle, params, mb)
                acc = map_leaves(lambda a, x: a + x.to(adt), acc, g)
                losses.append(loss_i)
                ms.append(m_i)
            grads = map_leaves(lambda a: a / n, acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        else:
            loss, metrics, grads = _loss_and_grads(bundle, params, batch)
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip)
        if hp.compress_grads:
            grads, ef = compress_decompress(grads, state["ef"])
        lr = sched(opt.step)
        params, opt = adamw_update(grads, opt, params, lr, weight_decay=hp.weight_decay)
        new_state = dict(state, params=params, opt=opt)
        if hp.compress_grads:
            new_state["ef"] = ef
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr, total=loss)

    return train_step


def init_train_state(bundle: ModelBundle, gen: torch.Generator | int, hp: TrainHParams) -> dict:
    """Fresh params from ``bundle.init(gen)`` (a seeded generator on the
    bundle's device, or its seed), zero AdamW moments[, zero error
    feedback]."""
    params = bundle.init(gen)
    state = {"params": params, "opt": adamw_init(params)}
    if hp.compress_grads:
        state["ef"] = ef_state_init(params)
    return state


def make_serve_step(bundle: ModelBundle) -> Callable:
    """(params, token [B], cache) → (logits, cache): the decode step."""
    return bundle.decode_step


def make_prefill_step(bundle: ModelBundle, capacity: int) -> Callable:
    return partial(bundle.prefill, capacity=capacity)
