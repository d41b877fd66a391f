"""Per-device accounting of a traced step: the port's counterpart of what
the reference reads from XLA's ``memory_analysis`` and ``cost_analysis``.

:class:`DeviceAccountant` is a ``TorchDispatchMode``.  Under
``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) it sees every ATen
op the port's single controller issues, on tensors that have shapes,
dtypes and devices but no storage, and keeps per device:

* live storage bytes and their peak.  A tensor's bytes are its untyped
  storage's, keyed by the storage, so a view never counts twice and an
  in-place op allocates nothing; a storage leaves when it is freed (a
  ``weakref.finalize`` on it).  Arguments are registered with
  :meth:`DeviceAccountant.hold` before the step and stay live.
* FLOPs, by ``torch.utils.flop_counter``'s formulas and its rule for ops
  without one (decompose if the op can be, else count nothing), charged to
  the device of the op's first output: over one device the sum is what
  ``FlopCounterMode`` counts.
* bytes accessed: the operand plus result bytes of every op that is not a
  view.  Eager PyTorch fuses nothing, so this is an upper bound on what
  XLA's ``bytes accessed`` counts for the same step.
* cross-device copies, each charged to the receiving device: the
  counterpart of the wire.  A copy a collective makes (its forward, or
  autograd's transpose of it: ``core.distributed.in_collective``) is the
  collective record's; every other copy is counted under "other".

Peak memory also runs over the sum of all devices (``total_peak``): what a
mesh whose shards all sit on one card needs of it.
"""
from __future__ import annotations

import collections
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import distributed as dist
from repro_torch.core.placement import Sharded, map_tree

aten = torch.ops.aten
# metadata queries: no storage, no FLOPs, no bytes (FlopCounterMode's list)
_META_OPS = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default, aten.sym_size.default,
    aten.stride.default, aten.sym_stride.default, aten.storage_offset.default,
    aten.sym_storage_offset.default, aten.numel.default, aten.sym_numel.default,
    aten.dim.default, torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
_NO_ACCESS = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default}
_COPIES = {aten._to_copy.default, aten.copy_.default}
_NO_DECOMPOSITION: set = set()  # ops whose decompose() gave NotImplemented


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_tensors(tree: Any) -> list[torch.Tensor]:
    """Every tensor of a tree of dicts / tuples / side-car dataclasses whose
    leaves are tensors or Sharded values (each piece)."""
    out = []

    def add(x):
        if isinstance(x, Sharded):
            out.extend(p for p in x.pieces if isinstance(p, torch.Tensor))
        elif isinstance(x, torch.Tensor):
            out.append(x)

    map_tree(add, tree)
    return out


class DeviceAccountant(TorchDispatchMode):
    """Per-device memory, FLOPs, bytes accessed and copies of the ops run
    under it (module docstring).  ``devices`` fixes the index of each
    device (a mesh's ``devices``, in mesh order); a device outside it gets
    the next index."""

    def __init__(self, devices=()):
        super().__init__()
        self.index: dict[torch.device, int] = {}
        for d in devices:
            self.index.setdefault(torch.device(d), len(self.index))
        self.live = collections.Counter()
        self.peak = collections.Counter()
        self.flops = collections.Counter()
        self.bytes_accessed = collections.Counter()
        self.copy_in = collections.Counter()     # bytes each device received
        self.other_in = collections.Counter()    # of those, no collective's
        self.other_count = collections.Counter()
        self.total_live = self.total_peak = 0
        self._storages: dict[int, tuple[int, int]] = {}

    # ------------------------------------------------------------ storages
    def dev(self, device) -> int:
        return self.index.setdefault(torch.device(device), len(self.index))

    def _track(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return False
        d, n = self.dev(t.device), st.nbytes()
        self._storages[key] = (d, n)
        weakref.finalize(st, self._release, key)
        self.live[d] += n
        self.total_live += n
        self.peak[d] = max(self.peak[d], self.live[d])
        self.total_peak = max(self.total_peak, self.total_live)
        return True

    def _release(self, key: int) -> None:
        d, n = self._storages.pop(key)
        self.live[d] -= n
        self.total_live -= n

    def hold(self, tree: Any) -> collections.Counter:
        """Register the tensors of ``tree`` (the step's arguments) as live;
        returns the bytes each device holds of them."""
        for t in tree_tensors(tree):
            self._track(t)
        return self.storage_bytes(tree)

    def storage_bytes(self, tree: Any) -> collections.Counter:
        """Bytes per device of the distinct storages under ``tree``."""
        seen, out = set(), collections.Counter()
        for t in tree_tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                out[self.dev(t.device)] += st.nbytes()
        return out

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry and func not in _NO_DECOMPOSITION:
            # FlopCounterMode's rule: an op without a formula is counted
            # through its decomposition where it has one
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _NO_DECOMPOSITION.add(func)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        d = self.dev(outs[0].device)
        if func._overloadpacket in flop_registry:
            self.flops[d] += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if not func.is_view and func not in _NO_ACCESS:
            self.bytes_accessed[d] += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                                       + sum(_nbytes(t) for t in outs))
        if func in _COPIES:
            src = args[1] if func is aten.copy_.default else args[0]
            if isinstance(src, torch.Tensor) and src.device != outs[0].device:
                n = _nbytes(outs[0])
                self.copy_in[d] += n
                if not dist.in_collective():
                    self.other_in[d] += n
                    self.other_count[d] += 1
        for t in outs:
            self._track(t)
        return out


__all__ = ["DeviceAccountant", "tree_tensors"]
