"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=1024 (attn-free) d_ff=0
vocab=50280, ssm_state=128.  d_inner = 2·1024 = 2048, head_dim 64 →
32 SSD heads.  FIER is INAPPLICABLE (no KV cache — DESIGN.md §5); the
arch runs without it and its decode state is O(1) per step natively.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    norm="rms",
    act="silu",
    use_rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_kernel=4,
    ssm_chunk=128,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
