"""minicpm-2b [dense]: llama-like; trains with the WSD schedule.

[arXiv:2404.06395; hf] 40L d_model=2304 36H (GQA kv=36, i.e. MHA)
d_ff=5760 vocab=122753.  36 heads is NOT divisible by the 16-way model
axis — this arch exercises the flattened-hidden-dim sharding path
(DESIGN.md §4).  The WSD (warmup-stable-decay) schedule is wired in
``repro.optim.schedules`` and selected by ``train.py --arch minicpm-2b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab=122753,
    norm="rms",
    act="silu",
    tie_embeddings=True,
    source="arXiv:2404.06395; hf",
)
