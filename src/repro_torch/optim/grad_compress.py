"""1-bit gradient compression with error feedback: the port of
``repro.optim.grad_compress``.

``compress_decompress`` passes each gradient through sign(g + e) ·
mean|g + e| and carries the error e to the next step (what a compressed
all-reduce would deliver; over a mesh's Sharded leaves the mean is taken
over the logical tensor, as the reference takes it over a global array);
``compressed_psum`` is the collective itself, single-controller (one
tensor per shard, as ``core/distributed.py``'s collectives);
``compressed_wire_bytes`` counts the bytes it sends per shard."""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core import distributed as dist
from repro_torch.core.placement import Sharded

from .tree import map_leaves


def ef_state_init(grads: Any) -> Any:
    return map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_decompress(grads: Any, ef: Any) -> tuple[Any, Any]:
    """sign(g+e)·mean|g+e| per tensor, with the error-feedback residual."""

    def one(g, e):
        if isinstance(g, Sharded):  # the mean over the logical tensor
            xs = [p.to(torch.float32) + q for p, q in zip(g.pieces, e.pieces)]
            tot = sum(torch.sum(torch.abs(x)).to(xs[0].device) for x in xs)
            scale = tot / g.numel()
            qs = [torch.sign(x) * scale.to(x.device) for x in xs]
            return g.with_pieces(qs), g.with_pieces([x - q for x, q in zip(xs, qs)])
        x = g.to(torch.float32) + e
        q = torch.sign(x) * torch.mean(torch.abs(x))
        return q, x - q

    out = _map_whole(one, grads, ef)
    return _map_whole(lambda t: t[0], out), _map_whole(lambda t: t[1], out)


def _map_whole(fn, tree, *rest):
    """``fn`` over whole leaves (a Sharded leaf is not split into pieces)."""
    if isinstance(tree, dict):
        return {k: _map_whole(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compressed_psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce mean of a 1-bit (sign + scale) representation of each
    shard's tensor: ``xs`` holds one tensor per shard of the group (the
    reference's ``compressed_psum(x, axis_name)`` inside ``shard_map``), and
    each shard gets, on its device, the mean over the shards of
    (x ≥ 0 ? +1 : −1) · mean|x|, in x's dtype.  Wire format per shard:
    ceil(n/8) sign bytes and one f32 scale."""
    contrib = []
    for x in xs:
        xf = x.to(torch.float32).reshape(-1)
        pm1 = (xf >= 0).to(torch.float32) * 2.0 - 1.0
        contrib.append(pm1 * torch.mean(torch.abs(xf)))
    total = dist.psum(contrib)
    return [(t / len(xs)).reshape(x.shape).to(x.dtype) for t, x in zip(total, xs)]


def compressed_wire_bytes(n_params: int, n_shards: int) -> int:
    """Bytes on the wire per shard for the compressed all-reduce."""
    return n_params // 8 + 4
