"""Carry the JAX package's parameters over to the port.

``params_from_jax(tree, cfg)`` takes the reference's parameter tree with
every leaf already turned into a numpy array (``jax.tree.map(np.asarray,
params)``; a bf16 leaf may arrive as an ml_dtypes bfloat16 array or as
float32 — both convert exactly) and returns the same nested dict of torch
tensors, so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, padded_vocab


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """The parameter tree of a transformer family — dense, moe or vlm —
    (embed, stacked layers, final_norm[, lm_head]; a moe layer holds ``moe``
    {router [L, d, E], w1/w3 [L, E, d, ff], w2 [L, E, ff, d]} where a dense
    one holds ``mlp``) as torch tensors on ``device`` (the card unless
    ``device='cpu'``).  Other families raise."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    params = _convert(tree, resolve_device(device))
    Vp = padded_vocab(cfg)
    if tuple(params["embed"].shape) != (Vp, cfg.d_model):
        raise ValueError(
            f"embed is {tuple(params['embed'].shape)}, expected ({Vp}, {cfg.d_model})"
        )
    L, d = cfg.n_layers, cfg.d_model
    want = {("attn", "wq"): (L, d, cfg.n_heads * cfg.d_head)}
    if cfg.family == "moe":
        E, ff = cfg.n_experts, cfg.d_ff
        want.update({("moe", "router"): (L, d, E), ("moe", "w1"): (L, E, d, ff),
                     ("moe", "w3"): (L, E, d, ff), ("moe", "w2"): (L, E, ff, d)})
    for (block, leaf), shape in want.items():
        got = params["layers"].get(block, {}).get(leaf)
        if got is None or tuple(got.shape) != shape:
            raise ValueError(f"layers.{block}.{leaf} is "
                             f"{None if got is None else tuple(got.shape)}: not a stacked "
                             f"{list(shape)} tree")
    return params
