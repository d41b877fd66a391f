"""olmo-1b [dense]: non-parametric LayerNorm (no learnable scale/bias).

[arXiv:2402.00838; hf] 16L d_model=2048 16H (GQA kv=16, i.e. MHA)
d_ff=8192 vocab=50304.  SwiGLU; RoPE; weight-tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric",
    act="silu",
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
)
