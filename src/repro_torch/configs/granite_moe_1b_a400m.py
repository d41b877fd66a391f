"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    norm="rms",
    act="silu",
    n_experts=32,
    topk_experts=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
