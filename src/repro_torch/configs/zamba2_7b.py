"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32)
d_ff=14336 vocab=32000, ssm_state=64.  One *weight-shared* attention+MLP
block is applied every ``attn_every``=6 Mamba2 layers, consuming
concat(hidden, original embedding) (width 2·d_model) per the Zamba2
design.  The shared block's KV cache is the only attention cache in the
model → FIER applies exactly there (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    norm="rms",
    act="silu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_kernel=4,
    # chunk 64 (not 128): the SSD intra-chunk decay tensor is
    # [B, nc, c, c, H] — with H=112 heads, c=128 costs 3.8 GB/layer/device
    # at train_4k; c=64 quarters it (EXPERIMENTS.md §Dry-run memory notes)
    ssm_chunk=64,
    attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242; unverified",
)
