"""command-r-plus-104b [dense]: GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000.  LayerNorm (bias-free), SwiGLU,
RoPE theta 75e6, tied embeddings.  Deviation noted: the HF model uses
parallel attn+FFN blocks; we use sequential blocks (same FLOPs/params to
first order) — recorded here per DESIGN.md §2.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab=256000,
    norm="layernorm",
    act="silu",
    rope_theta=75e6,
    tie_embeddings=True,
    param_dtype="bfloat16",  # 104B: bf16 params + fp32 master in optimizer
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
