"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus their build (``build.py``) and ``CacheView`` entry points
(``ops.py``).

    K1 fier_retrieve               csrc/fier_retrieve.cuh ← fused_retrieval.fused_retrieve_hm
    K2 fier_attend_selected        csrc/fier_attend.cuh   ← sparse_attention.fused_sparse_attention_hm
    K3 fier_retrieve_paged         csrc/fier_retrieve.cuh ← fused_retrieval.paged_fused_retrieve_hm
    K4 fier_attend_selected_paged  csrc/fier_attend.cuh   ← sparse_attention.paged_fused_sparse_attention_hm
    K5 fier_pack_quantize          csrc/fier_pack.cu      ← pack_quantize.pack_quantize_hm
    K6 fier_score_scan             csrc/fier_score.cu     ← fier_score.fier_score_hm
    K7 fier_topk_threshold         csrc/fier_topk.cu      ← topk_select.topk_threshold_hm
    K8 fier_attend_gathered        csrc/fier_attend.cuh   ← sparse_attention.sparse_attention_hm

K3 and K4 are ``fier_retrieve`` / ``fier_attend_selected`` given a
``block_table``; each layout keeps its own launch count.  K1, K3 and K6
share the scoring warp and K1, K3 and K7 the radix search
(``csrc/fier_common.cuh``); K2, K4 and K8 share one kernel body and its plan.
"""
from __future__ import annotations

from . import fier_score, fused_retrieval, pack_quantize, sparse_attention, topk_select

# kernel name → (wrapper module, the module attribute counting its launches)
_MODULES = {
    "fier_retrieve": (fused_retrieval, "launches"),
    "fier_attend_selected": (sparse_attention, "launches"),
    "fier_retrieve_paged": (fused_retrieval, "launches_paged"),
    "fier_attend_selected_paged": (sparse_attention, "launches_paged"),
    "pack_quantize": (pack_quantize, "launches"),
    "fier_score": (fier_score, "launches"),
    "topk_threshold": (topk_select, "launches"),
    "sparse_attention": (sparse_attention, "launches_gathered"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in _MODULES.values():
        setattr(mod, attr, 0)
