"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8, 94 layers.

[hf:Qwen/Qwen3-30B-A3B; hf] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128e top-8.  d_head=128 (q/k projections
are d_model → n_heads·128, wider than d_model — Qwen3 style).  Deviation
noted: Qwen3 applies QK-norm; we omit it (orthogonal to FIER; recorded per
DESIGN.md §2).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    norm="rms",
    act="silu",
    rope_theta=1e6,
    n_experts=128,
    topk_experts=8,
    param_dtype="bfloat16",  # 235B: bf16 params + fp32 master in optimizer
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
