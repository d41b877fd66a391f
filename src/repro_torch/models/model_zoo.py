"""build(cfg) → ModelBundle dispatch over architecture families (dense only
in this slice)."""
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
    dev = resolve_device(device)
    if cfg.family == "dense":
        return transformer.build(cfg, pol, device=dev)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)"
    )
