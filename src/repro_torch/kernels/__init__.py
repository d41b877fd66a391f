"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus their build (``build.py``) and ``CacheView`` entry points
(``ops.py``).

    K1 fier_retrieve         csrc/fier_retrieve.cu   ← fused_retrieval.fused_retrieve_hm
    K2 fier_attend_selected  csrc/fier_attend.cu     ← sparse_attention.fused_sparse_attention_hm
"""
from __future__ import annotations

from . import fused_retrieval, sparse_attention

_MODULES = {
    "fier_retrieve": fused_retrieval,
    "fier_attend_selected": sparse_attention,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
