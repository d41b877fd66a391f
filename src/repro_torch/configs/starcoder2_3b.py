"""starcoder2-3b [dense]: GQA kv=2, RoPE.

[arXiv:2402.19173; hf] 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  LayerNorm with biases, GeLU MLP, qkv biases, tied embeddings.
kv=2 makes the GQA query-group score reduction (DESIGN.md §2) maximally
load-bearing for FIER here.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2402.19173; hf",
)
