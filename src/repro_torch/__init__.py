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


def tracing_fake() -> bool:
    """Whether a ``FakeTensorMode`` is active: a trace of shapes on fake
    devices (``launch/dryrun.py``) that allocates nothing and touches no
    card."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on.  ``None`` means the default,
    CUDA; a CUDA device without a usable card raises — the port never
    drops to the CPU unless asked to.  ``meta`` (shapes only, nothing runs)
    is accepted, and under a fake trace (:func:`tracing_fake`) any device,
    with no query of the CUDA runtime."""
    dev = torch.device("cuda" if device is None else device)
    if tracing_fake():
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
