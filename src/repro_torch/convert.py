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


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cpu") -> dict:
    """The dense-transformer parameter tree (embed, stacked layers,
    final_norm[, lm_head]) as torch tensors on ``device``."""
    params = _convert(tree, device)
    Vp = padded_vocab(cfg)
    if tuple(params["embed"].shape) != (Vp, cfg.d_model):
        raise ValueError(
            f"embed is {tuple(params['embed'].shape)}, expected ({Vp}, {cfg.d_model})"
        )
    wq = params["layers"]["attn"]["wq"]
    if tuple(wq.shape) != (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.d_head):
        raise ValueError(f"layers.attn.wq is {tuple(wq.shape)}: not a stacked "
                         f"[{cfg.n_layers}, {cfg.d_model}, {cfg.n_heads * cfg.d_head}] tree")
    return params
