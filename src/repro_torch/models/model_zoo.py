"""build(cfg) → ModelBundle dispatch over architecture families: dense, moe
and vlm share ``transformer.build``; ssm, hybrid and encdec are not ported
yet (ROADMAP Queue 1 item 9)."""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import PolicyConfig

from . import transformer
from .transformer import ModelBundle


def build_model(
    cfg: ModelConfig, pol: PolicyConfig | None = None, *, device="cuda"
) -> ModelBundle:
    """The model bundle for ``cfg`` on ``device`` (CUDA by default; a
    missing card raises)."""
    if pol is not None and pol.layout == "paged" and cfg.family not in transformer.FAMILIES:
        raise ValueError(
            f"paged KV cache is only supported for transformer families, not {cfg.family!r}"
        )
    dev = resolve_device(device)
    if cfg.family in transformer.FAMILIES:
        return transformer.build(cfg, pol, device=dev)
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
