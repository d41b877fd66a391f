"""Carry the JAX package's parameters and train states over to the port.

``params_from_jax(tree, cfg)`` takes the reference's parameter tree with
every leaf already turned into a numpy array (``jax.tree.map(np.asarray,
params)``; a bf16 leaf may arrive as an ml_dtypes bfloat16 array or as
float32 — both convert exactly) and returns the same nested dict of torch
tensors, so both packages compute the same function.  ``train_state_from_jax``
does the same for a train state: params, the AdamW moments and step, and
the error-feedback residual where there is one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.optim import AdamWState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _shape_of(tree: dict, path: str):
    node = tree
    for key in path.split("."):
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return tuple(node.shape)


def _expected_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """The leaves whose shapes identify each family's stacked tree."""
    L, d, Vp = cfg.n_layers, cfg.d_model, padded_vocab(cfg)
    want = {"embed": (Vp, d)}
    if cfg.family in ("dense", "moe", "vlm"):
        want["layers.attn.wq"] = (L, d, cfg.n_heads * cfg.d_head)
        if cfg.family == "moe":
            E, ff = cfg.n_experts, cfg.d_ff
            want.update({"layers.moe.router": (L, d, E), "layers.moe.w1": (L, E, d, ff),
                         "layers.moe.w3": (L, E, d, ff), "layers.moe.w2": (L, E, ff, d)})
        return want
    if cfg.family in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        proj = (d, 2 * di + 2 * N + H)
        conv = (cfg.conv_kernel, di + 2 * N)
        want["final_norm"] = (d,)
        if cfg.family == "ssm":
            want.update({"layers.in_proj": (L, *proj), "layers.conv_w": (L, *conv),
                         "layers.out_proj": (L, di, d)})
            return want
        n_apps = L // cfg.attn_every
        lead, tail = (n_apps, cfg.attn_every), L - n_apps * cfg.attn_every
        want.update({"mamba.in_proj": (*lead, *proj), "mamba.conv_w": (*lead, *conv),
                     "mamba.out_proj": (*lead, di, d),
                     "shared.attn.wq": (2 * d, cfg.n_heads * cfg.d_head),
                     "shared.attn.wo": (cfg.n_heads * cfg.d_head, d),
                     "shared.mlp.w1": (d, cfg.d_ff)})
        if tail:
            want["mamba_tail.in_proj"] = (tail, *proj)
        return want
    if cfg.family == "encdec":
        hd = cfg.n_heads * cfg.d_head
        want.update({"enc_layers.attn.wq": (cfg.n_enc_layers, d, hd),
                     "dec_layers.self_attn.wq": (L, d, hd),
                     "dec_layers.cross_attn.wk": (L, d, cfg.n_kv_heads * cfg.d_head),
                     "dec_layers.norm_x.w": (L, d), "dec_norm.w": (d,), "enc_norm.w": (d,)})
        return want
    raise ValueError(f"unknown family {cfg.family!r}")


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda",
                    max_positions: int | None = None) -> dict:
    """The parameter tree of any family as torch tensors on ``device`` (the
    card unless ``device='cpu'``), shape-checked against ``cfg``:

    * dense, moe, vlm: embed, stacked ``layers``, final_norm[, lm_head]; a
      moe layer holds ``moe`` {router [L, d, E], w1/w3 [L, E, d, ff],
      w2 [L, E, ff, d]} where a dense one holds ``mlp``;
    * ssm (mamba2): embed, stacked ``layers`` of Mamba2 blocks, final_norm;
    * hybrid (zamba2): embed, ``mamba`` [n_apps, attn_every, ...],
      ``mamba_tail`` [n_layers − n_apps·attn_every, ...] (when any),
      ``shared`` (the one attention + MLP block, unstacked), final_norm;
    * encdec (whisper): embed, ``pos_dec`` [max_positions or
      max_target_positions, d], ``enc_layers``, ``enc_norm``, ``dec_layers``
      (``self_attn``, ``cross_attn``, ``norm_x`` beside the transformer
      layer's leaves), ``dec_norm``."""
    params = _convert(tree, resolve_device(device))
    want = _expected_shapes(cfg)
    if cfg.family == "encdec":
        want["pos_dec"] = (max_positions or cfg.max_target_positions, cfg.d_model)
    for path, shape in want.items():
        got = _shape_of(params, path)
        if got != shape:
            raise ValueError(f"{path} is {got}: not the {list(shape)} leaf of a "
                             f"{cfg.family} tree for {cfg.name}")
    return params


def train_state_from_jax(state: dict, cfg: ModelConfig, *, device="cuda",
                         max_positions: int | None = None) -> dict:
    """The reference's train state ``{"params", "opt": AdamWState(step, mu,
    nu)[, "ef"]}`` with numpy leaves (``jax.tree.map(np.asarray, state)``)
    as the port's: every params-shaped tree through ``params_from_jax``
    (shape-checked against ``cfg``), the step an int32 scalar."""
    opt = state["opt"]
    step, mu, nu = (opt.step, opt.mu, opt.nu) if hasattr(opt, "mu") else (
        opt["step"], opt["mu"], opt["nu"])
    tree = lambda t: params_from_jax(t, cfg, device=device, max_positions=max_positions)
    out = {
        "params": tree(state["params"]),
        "opt": AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                            device=resolve_device(device)),
                          mu=tree(mu), nu=tree(nu)),
    }
    if "ef" in state:
        out["ef"] = tree(state["ef"])
    return out
