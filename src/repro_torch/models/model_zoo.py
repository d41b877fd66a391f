"""build(cfg) → ModelBundle dispatch over architecture families: dense, moe
and vlm share ``transformer.build``; ssm → ``mamba2.build``, hybrid →
``hybrid.build``, encdec → ``encdec.build``."""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import PolicyConfig

from . import encdec, hybrid, mamba2, sharded_train, transformer
from .transformer import ModelBundle


def build_model(
    cfg: ModelConfig, pol: PolicyConfig | None = None, dcfg=None, *, device="cuda",
    remat: bool = True, max_positions: int | None = None,
) -> ModelBundle:
    """The model bundle for ``cfg`` on ``device`` (CUDA by default; a
    missing card raises).  ``remat`` rematerialises each layer (the
    hybrid: each application point) in ``train_loss``'s backward.
    ``max_positions`` sizes an encdec decoder's learned position table (the
    config's ``max_target_positions`` when None); other families ignore it.
    A paged layout is refused for every family but the transformer's, as in
    the reference.  ``dcfg`` (``attention.DistConfig``) threads a mesh: a
    bundle built with ``dcfg.mesh`` trains over it (``sharded_train``:
    Megatron TP × DP for the transformer families, DP for the others), and
    the transformer families also decode over it."""
    if pol is not None and pol.layout == "paged" and cfg.family not in transformer.FAMILIES:
        raise ValueError(
            f"paged KV cache is only supported for transformer families, not {cfg.family!r}"
        )
    dev = resolve_device(device)
    if cfg.family in transformer.FAMILIES:
        return transformer.build(cfg, pol, dcfg, device=dev, remat=remat)
    if dcfg is not None and (dcfg.seq_axes or dcfg.shard is not None):
        raise ValueError(f"a mesh-sharded decode is only built for the transformer "
                         f"families, not {cfg.family!r}")
    if cfg.family == "ssm":
        bundle = mamba2.build(cfg, device=dev, remat=remat)
    elif cfg.family == "hybrid":
        bundle = hybrid.build(cfg, pol, device=dev, remat=remat)
    elif cfg.family == "encdec":
        bundle = encdec.build(cfg, pol, device=dev, remat=remat, max_positions=max_positions)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if dcfg is not None and dcfg.mesh is not None:
        bundle.train_loss = sharded_train.data_parallel_loss(bundle, dcfg)
        bundle.dcfg = dcfg
    return bundle
