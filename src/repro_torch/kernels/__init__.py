"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus their build (``build.py``) and ``CacheView`` entry points
(``ops.py``).

    K1 fier_retrieve               csrc/fier_retrieve.cu  ← fused_retrieval.fused_retrieve_hm
    K2 fier_attend_selected        csrc/fier_attend.cu    ← sparse_attention.fused_sparse_attention_hm
    K3 fier_retrieve_paged         csrc/fier_retrieve.cu  ← fused_retrieval.paged_fused_retrieve_hm
    K4 fier_attend_selected_paged  csrc/fier_attend.cu    ← sparse_attention.paged_fused_sparse_attention_hm

K3 and K4 are ``fier_retrieve`` / ``fier_attend_selected`` given a
``block_table``; each layout keeps its own launch count.
"""
from __future__ import annotations

from . import fused_retrieval, sparse_attention

# kernel name → (wrapper module, the module attribute counting its launches)
_MODULES = {
    "fier_retrieve": (fused_retrieval, "launches"),
    "fier_attend_selected": (sparse_attention, "launches"),
    "fier_retrieve_paged": (fused_retrieval, "launches_paged"),
    "fier_attend_selected_paged": (sparse_attention, "launches_paged"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in _MODULES.values():
        setattr(mod, attr, 0)
