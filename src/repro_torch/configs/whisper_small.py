"""whisper-small [audio]: enc-dec, conv frontend stubbed (precomputed frames).

[arXiv:2212.04356; unverified] 12L d_model=768 12H (GQA kv=12) d_ff=3072
vocab=51865.  Decoder positions bounded at 448 by family design; encoder
audio context 1500 frames.  Norm: LayerNorm; act: GeLU; learned positions
(no RoPE).  long_500k is skipped for this arch (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    use_rope=False,
    qkv_bias=True,
    tie_embeddings=True,
    enc_ctx=1500,
    max_target_positions=448,
    source="arXiv:2212.04356; unverified",
)
