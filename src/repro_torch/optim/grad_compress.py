"""1-bit gradient compression with error feedback: the port of
``repro.optim.grad_compress``.

``compress_decompress`` passes each gradient through sign(g + e) ·
mean|g + e| and carries the error e to the next step (what a compressed
all-reduce would deliver); ``compressed_wire_bytes`` counts the bytes such
an all-reduce sends per shard.  ``compressed_psum`` is the collective
itself and raises: training's collectives wait for ROADMAP Queue 1 item
10's training part."""
from __future__ import annotations

from typing import Any

import torch

from .tree import map_leaves


def ef_state_init(grads: Any) -> Any:
    return map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_decompress(grads: Any, ef: Any) -> tuple[Any, Any]:
    """sign(g+e)·mean|g+e| per tensor, with the error-feedback residual."""

    def one(g, e):
        x = g.to(torch.float32) + e
        q = torch.sign(x) * torch.mean(torch.abs(x))
        return q, x - q

    out = map_leaves(one, grads, ef)
    return map_leaves(lambda t: t[0], out), map_leaves(lambda t: t[1], out)


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The 1-bit all-reduce over a device mesh: not ported."""
    raise NotImplementedError(
        "compressed_psum is a collective over a device mesh of training; it is not "
        "ported yet (ROADMAP Queue 1 item 10, its training part)"
    )


def compressed_wire_bytes(n_params: int, n_shards: int) -> int:
    """Bytes on the wire per shard for the compressed all-reduce."""
    return n_params // 8 + 4
