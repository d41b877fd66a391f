"""FIER on PyTorch + CUDA: the port of ``repro`` (JAX/Pallas on TPU) to one
NVIDIA H100.

Same layout as the JAX package (``configs``, ``core``, ``kernels``,
``kvcache``, ``models``, ``serving``) so every module has an obvious
counterpart.  Plain tensor code is PyTorch; each Pallas kernel on the
ported path is a CUDA C++ kernel for ``sm_90a`` under ``kernels/csrc``,
built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the parity tests do); on the CPU each kernel wrapper
runs its plain PyTorch version.  The package never imports ``jax`` or
``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on.  ``None`` means the default,
    CUDA; a CUDA device without a usable card raises — the port never
    drops to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
