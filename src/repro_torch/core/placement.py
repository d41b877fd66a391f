"""Sharded values over a device mesh: the port's counterpart of
``jax.sharding`` and ``jax.device_put`` for one controlling process.

A :class:`NamedSharding` is a partition spec :class:`P` over a mesh
(``launch.mesh.Mesh``; only its ``axis_names``, ``shape``, ``devices`` and
``device_at`` are read here).  :func:`place` turns a tensor into a
:class:`Sharded` value — its sharding and its pieces in mesh order, each
on its shard's device — and the sharded train step
(``models/sharded_train.py``) computes with the pieces and the collectives
of ``core/distributed.py``.  A piece that the spec replicates over some
mesh axes is stored once, on the first shard of its replica group; the
other shards of the group read it (``.to(device)``, whose backward sums
their gradients: the data-parallel all-reduce).  So every logical element
is held, and counted, once: a global norm, a tree's bytes and a
compression scale read each logical element exactly once.
``Sharded.full()`` gathers the logical tensor back.

A spec may name an axis the mesh lacks (the TP rules on a data-only mesh):
that axis counts as size 1.  Which spec each parameter gets is the
sharding plan's business (``launch/sharding.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable, Sequence

import torch

from . import distributed as dist

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh


def axis_coords(mesh: "Mesh", axes: Sequence[str], index: int) -> dict[str, int]:
    """The coordinates along ``axes`` of shard ``index`` of the group they
    span, row-major over ``axes`` in the given order (the linear index that
    ``jax.lax.axis_index`` over several axes counts)."""
    coords = {}
    for ax in reversed(tuple(axes)):
        index, coords[ax] = divmod(index, mesh.shape[ax])
    if index:
        raise IndexError(f"shard index out of range for axes {tuple(axes)}")
    return coords


class P(tuple):
    """A partition spec: per dim, a mesh axis name, a tuple of names, or
    None (replicated).  Dims past the spec's length are replicated.  A
    one-name tuple is stored as the name, as ``jax.sharding.PartitionSpec``
    stores it."""

    def __new__(cls, *dims):
        norm = []
        for d in dims:
            if isinstance(d, (tuple, list)):
                d = tuple(d)
                d = None if not d else (d[0] if len(d) == 1 else d)
            norm.append(d)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh."""

    mesh: "Mesh"
    spec: P

    def dim_axes(self, ndim: int) -> tuple[tuple[str, ...], ...]:
        """Per dim, the mesh axes it splits over (axes the mesh lacks left
        out)."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more dims than a rank-{ndim} value")
        out = []
        for d in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            names = () if d is None else ((d,) if isinstance(d, str) else tuple(d))
            out.append(tuple(a for a in names if a in self.mesh.shape))
        return tuple(out)

    def grid(self, shape) -> tuple[int, ...]:
        """Blocks per dim for a value of ``shape``; raises if a dim does not
        divide."""
        grid = []
        for n, axes in zip(shape, self.dim_axes(len(shape))):
            k = math.prod(self.mesh.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"dim of size {n} does not divide over {axes} ({k} shards)")
            grid.append(k)
        return tuple(grid)

    def block_of(self, flat: int, ndim: int) -> tuple[int, ...]:
        """The block (index along each dim) the mesh shard ``flat`` holds."""
        coords = axis_coords(self.mesh, self.mesh.axis_names, flat)
        block = []
        for axes in self.dim_axes(ndim):
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coords[a]
            block.append(i)
        return tuple(block)

    def blocks(self, ndim: int) -> list[tuple[tuple[int, ...], int]]:
        """The distinct blocks in mesh order of first appearance, each with
        the flat index of the shard that stores it."""
        seen: dict[tuple[int, ...], int] = {}
        for flat in range(self.mesh.size):
            seen.setdefault(self.block_of(flat, ndim), flat)
        return list(seen.items())


def _gather(xs, dim, device):
    """The gather before use (``Sharded.view``): the all-gather of one
    shard, kept as a name of its own so a test can plant a fault in it."""
    return dist.gather(xs, dim, device)


class Sharded:
    """A logical tensor split over a mesh: its sharding, logical shape and
    dtype, and one piece per distinct block in mesh order, each on the
    device of the shard that stores it (``NamedSharding.blocks``)."""

    def __init__(self, sharding: NamedSharding, shape, pieces):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.grid = sharding.grid(self.shape)
        layout = sharding.blocks(len(self.shape))
        if len(pieces) != len(layout):
            raise ValueError(f"{len(layout)} blocks, {len(pieces)} pieces")
        self.pieces = list(pieces)
        self.blocks = [b for b, _ in layout]
        self.owners = [o for _, o in layout]
        self._index = {b: i for i, b in enumerate(self.blocks)}

    @property
    def mesh(self) -> "Mesh":
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def piece(self, block) -> torch.Tensor:
        return self.pieces[self._index[tuple(block)]]

    def _assemble(self, index_lists, device, gather=dist.gather) -> torch.Tensor:
        def rec(dim, prefix):
            if dim == self.ndim:
                return self.piece(prefix).to(device)
            parts = [rec(dim + 1, prefix + (i,)) for i in index_lists[dim]]
            return parts[0] if len(parts) == 1 else gather(parts, dim, device)

        return rec(0, ())

    def full(self, device=None) -> torch.Tensor:
        """The logical tensor, gathered on ``device`` (the first piece's
        device by default)."""
        return self._assemble([range(g) for g in self.grid],
                              self.device if device is None else device)

    def view(self, coords: dict[str, int], keep: dict[int, tuple[str, ...]], device) -> torch.Tensor:
        """What the shard at ``coords`` computes with, on ``device``: along a
        dim d in ``keep`` that is split over exactly ``keep[d]``, its own
        block; along one split otherwise, the blocks gathered whole and, if
        ``keep[d]`` names axes, cut to the shard's block over them; every
        other dim gathered whole (the FSDP gather before use)."""
        flat = 0
        for a in self.mesh.axis_names:
            flat = flat * self.mesh.shape[a] + coords.get(a, 0)
        own = self.sharding.block_of(flat, self.ndim)
        stored = self.sharding.dim_axes(self.ndim)
        want = NamedSharding(self.mesh, P(*[keep.get(d) for d in range(self.ndim)]))
        want_axes = want.dim_axes(self.ndim)
        lists, cuts = [], []
        for d in range(self.ndim):
            if stored[d] == want_axes[d]:
                lists.append([own[d]])
            else:
                lists.append(range(self.grid[d]))
                if want_axes[d]:
                    k = math.prod(self.mesh.shape[a] for a in want_axes[d])
                    cuts.append((d, want.block_of(flat, self.ndim)[d], k))
        x = self._assemble(lists, device, _gather)
        for d, i, k in cuts:
            n = x.shape[d] // k
            x = x.narrow(d, i * n, n)
        return x

    def map_pieces(self, fn: Callable, *rest: "Sharded") -> "Sharded":
        """``fn`` over the pieces (and the matching pieces of ``rest``, which
        share this sharding); the result keeps the sharding."""
        return self.with_pieces([fn(p, *(r.pieces[i] for r in rest))
                                 for i, p in enumerate(self.pieces)])

    def with_pieces(self, pieces: list) -> "Sharded":
        """This value's sharding and layout over other pieces (which need
        not be tensors: the optimizer maps to per-piece tuples)."""
        out = Sharded.__new__(Sharded)
        out.__dict__.update(self.__dict__)
        out.pieces = list(pieces)
        return out

    def unstack(self, n: int) -> list["Sharded"]:
        """The n values along an unsplit leading dim (one ``torch.unbind``
        per piece, as ``models.transformer.unstack``)."""
        if self.grid[0] != 1:
            raise ValueError("the leading dim is split; it cannot be unstacked")
        sh = NamedSharding(self.mesh, P(*tuple(self.spec)[1:]))
        per = [torch.unbind(p, 0) for p in self.pieces]
        return [Sharded(sh, self.shape[1:], [u[i] for u in per]) for i in range(n)]

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"{len(self.pieces)} pieces)")


def as_sharded(x, mesh: "Mesh") -> Sharded:
    """``x`` itself if Sharded, else a plain tensor as a replicated value
    over ``mesh`` whose one piece is the tensor (so its gradient reaches
    it)."""
    return x if isinstance(x, Sharded) else Sharded(NamedSharding(mesh, P()), x.shape, [x])


class AtUse:
    """A Sharded leaf bound to the shard that computes with it, gathered
    whole on that shard's device only where a layer uses it:
    ``models.transformer.unstack`` splits it into per-layer values and
    ``models.transformer.checkpointed`` gathers them inside the remat
    scope (the FSDP gather before use; the backward regathers)."""

    def __init__(self, x: Sharded, coords: dict[str, int], device):
        self.x, self.coords, self.device = x, coords, device

    def unstack(self, n: int) -> list["AtUse"]:
        return [AtUse(v, self.coords, self.device) for v in self.x.unstack(n)]

    def get(self) -> torch.Tensor:
        return self.x.view(self.coords, {}, self.device)


def resolve_at_use(tree: Any) -> Any:
    """``tree`` (nested tuples, lists and dicts) with every AtUse gathered."""
    if isinstance(tree, AtUse):
        return tree.get()
    if isinstance(tree, dict):
        return {k: resolve_at_use(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(resolve_at_use(v) for v in tree)
    return tree


# --------------------------------------------------------------- placement

def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts / named tuples / tuples /
    lists (a Sharded is a leaf), with same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


@torch.no_grad()
def place(x, sharding: NamedSharding):
    """The counterpart of ``jax.device_put(x, sharding)`` for one leaf: a
    :class:`Sharded` whose pieces are copies of ``x``'s blocks, each on the
    device of the shard that stores it.  ``x`` may be a tensor or a Sharded
    (re-placed through its logical tensor).  A 0-dim value has no dim to
    split: it stays a tensor, on the mesh's first device."""
    if isinstance(x, Sharded):
        x = x.full()
    mesh = sharding.mesh
    if x.dim() == 0:
        return x.to(mesh.devices[0], copy=True)
    grid = sharding.grid(x.shape)
    pieces = []
    for block, owner in sharding.blocks(x.dim()):
        part = x
        for d, (i, k) in enumerate(zip(block, grid)):
            if k > 1:
                n = x.shape[d] // k
                part = part.narrow(d, i * n, n)
        pieces.append(part.to(mesh.devices[owner]).clone(memory_format=torch.contiguous_format))
    return Sharded(sharding, x.shape, pieces)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``place`` every leaf of ``tree`` by the matching leaf of
    ``shardings`` (a tree of the same structure) or by one sharding."""
    if isinstance(shardings, NamedSharding):
        return map_tree(lambda a: place(a, shardings), tree)
    return map_tree(place, tree, shardings)


def gather_tree(tree: Any, device=None) -> Any:
    """Every Sharded leaf as its logical tensor (on ``device``, or its first
    piece's)."""
    return map_tree(lambda a: a.full(device) if isinstance(a, Sharded) else a, tree)


def shard_bytes(x: Sharded) -> list[int]:
    """Bytes each stored piece of ``x`` holds."""
    return [p.numel() * p.element_size() for p in x.pieces]


def split_batch(batch: dict, mesh: "Mesh", batch_axes_: tuple[str, ...]) -> list[dict]:
    """The batch's slices, one per data shard in order over ``batch_axes_``
    (every leaf's leading dim split, a VLM's ``vision_embeds`` too), each
    on the device of the data shard's first shard."""
    axes = [a for a in batch_axes_ if a in mesh.shape]
    n = math.prod(mesh.shape[a] for a in axes)
    out = []
    for t in range(n):
        dev = mesh.device_at(axis_coords(mesh, axes, t))
        out.append({k: None if v is None else
                    v.narrow(0, t * (v.shape[0] // n), v.shape[0] // n).to(dev)
                    for k, v in batch.items()})
    return out


__all__ = [
    "AtUse", "NamedSharding", "P", "Sharded", "as_sharded", "axis_coords", "gather_tree",
    "map_tree", "place", "place_tree", "resolve_at_use", "shard_bytes", "split_batch",
]
