"""Device meshes: named axes over a grid of devices (port of
``repro.launch.mesh``).

A :class:`Mesh` is what ``jax.sharding.Mesh`` is to the reference, for one
controlling process: ``axis_names``, ``shape[axis]`` and a row-major grid of
``torch.device``s, one per shard.  The port is single-controller, as the
reference is: one process holds the host state (block tables, allocator,
scheduler) and runs each shard's share of a step on that shard's device.
The grid may repeat a device — every shard on ``cpu`` (the tests), or two or
four shards on one card — so a mesh never needs more cards than there are.

Axis meanings, as in the reference:
    pod    — data parallel across hosts (a mesh of one host has none)
    data   — data parallel: slots (serving), batch and FSDP storage (training)
    model  — tensor / expert parallel + decode-time KV sequence sharding

The reference's ``make_production_mesh`` (the 512-chip TPU v5e layout) has
no counterpart: it exists for the XLA dry run, which the port does not
have (ROADMAP, Modules with no counterpart).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import resolve_device


class Mesh:
    """Named axes over a row-major grid of devices (the last axis fastest).

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``devices`` holds one device per shard in row-major order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device | str]):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axes must have size >= 1, got {shape}")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh of shape {shape} needs {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device of the shard at ``coords`` (axis → index; an axis left
        out is at index 0)."""
        flat = 0
        for ax in self.axis_names:
            i = coords.get(ax, 0)
            if not 0 <= i < self.shape[ax]:
                raise IndexError(f"index {i} out of range for mesh axis {ax!r} "
                                 f"of size {self.shape[ax]}")
            flat = flat * self.shape[ax] + i
        return self.devices[flat]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices})})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` with every shard on one device (the
    CUDA card unless ``device='cpu'``): the tests' mesh, and the one card's."""
    dev = resolve_device(device)
    return Mesh(shape, axes, [dev] * math.prod(shape))


def make_local_mesh(model_axis: int = 1, *, device="cuda") -> Mesh:
    """A ("data", "model") mesh over the visible devices: the cards, or the
    CPU.  With n devices and n divisible by ``model_axis`` the grid is
    (n / model_axis, model_axis), one shard per device; with fewer devices
    than ``model_axis`` (a divisor of it) the grid is (1, model_axis) and the
    shards take the devices in turn, so ``model_axis=2`` runs on one card."""
    dev = resolve_device(device)
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs)
    if n % model_axis == 0:
        return Mesh((n // model_axis, model_axis), ("data", "model"), devs)
    if model_axis % n == 0:
        return Mesh((1, model_axis), ("data", "model"),
                    [devs[i % n] for i in range(model_axis)])
    raise ValueError(f"{n} devices cannot form a mesh with model axis {model_axis}")


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes a training batch splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axes(mesh: Mesh, param_bytes: float) -> tuple[str, ...]:
    """FSDP policy: everything shards over 'data'; >50 GB param trees also
    shard over 'pod' (ZeRO-3 across pods)."""
    if param_bytes > 50e9 and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)
