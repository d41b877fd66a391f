"""Config registry: ``get_config(arch_id)`` + reduced configs for smoke tests.

A verbatim copy of ``repro.configs`` (pure Python): the port imports
nothing of the JAX package, so it carries its own registry."""
from __future__ import annotations

import dataclasses

from . import (
    command_r_plus_104b,
    granite_moe_1b_a400m,
    llava_next_mistral_7b,
    mamba2_370m,
    minicpm_2b,
    olmo_1b,
    qwen3_moe_235b_a22b,
    starcoder2_3b,
    whisper_small,
    zamba2_7b,
)
from .base import SHAPES, MeshConfig, ModelConfig, PolicyDefaults, ShapeConfig, padded_vocab

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        whisper_small,
        llava_next_mistral_7b,
        olmo_1b,
        command_r_plus_104b,
        starcoder2_3b,
        minicpm_2b,
        mamba2_370m,
        granite_moe_1b_a400m,
        qwen3_moe_235b_a22b,
        zamba2_7b,
    )
}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def reduced_config(arch: str) -> ModelConfig:
    """Same family/topology, tiny dims — CPU smoke tests (full configs are
    exercised only via the ShapeDtypeStruct dry-run)."""
    c = get_config(arch)
    kv = 2 if c.n_kv_heads and c.n_kv_heads < c.n_heads else 4
    red = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if c.n_heads else 0,
        n_kv_heads=(kv if c.n_kv_heads else 0),
        d_head=16 if c.d_head else 0,
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        rope_theta=min(c.rope_theta, 1e4),
    )
    if c.family == "moe":
        red.update(n_experts=4, topk_experts=2, d_ff=64)
    if c.family in ("ssm", "hybrid"):
        red.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16, n_layers=4)
    if c.family == "hybrid":
        red.update(attn_every=2, n_heads=4, n_kv_heads=4, d_head=32, d_ff=128)
    if c.family == "encdec":
        red.update(n_enc_layers=2, enc_ctx=16, max_target_positions=128)
    if c.family == "vlm":
        red.update(n_vision_tokens=8)
    return dataclasses.replace(c, **red)


# long_500k applicability (DESIGN.md §5): skipped only for whisper-small
# (family-bounded decoder positions); FIER-enabled attention archs run it
# because FIER decode is linear-scan + O(budget) attention.
def shape_cells(arch: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    if arch.replace("_", "-") == "whisper-small":
        cells.remove("long_500k")
    return cells


__all__ = [
    "ARCHS",
    "SHAPES",
    "MeshConfig",
    "ModelConfig",
    "PolicyDefaults",
    "ShapeConfig",
    "get_config",
    "padded_vocab",
    "reduced_config",
    "shape_cells",
]
