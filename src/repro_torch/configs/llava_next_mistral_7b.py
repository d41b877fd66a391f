"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, anyres tiling stubbed.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The vision tower + anyres tiling is a
STUB per assignment: ``input_specs()`` provides precomputed patch
embeddings [B, n_vision_tokens, d_model] which the backbone consumes as a
prefix of the sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    norm="rms",
    act="silu",
    rope_theta=1e6,
    n_vision_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
