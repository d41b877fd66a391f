"""Checkpoint manager: atomic, async-capable; the port of
``repro.checkpoint.manager`` with the same on-disk layout::

    <dir>/step_000000123.tmp/ → (atomic rename) → <dir>/step_000000123/
        manifest.json          leaf names, shapes, dtypes, step
        shard_p0.npz           the leaves, a0, a1, ... in leaf order

* Leaf names and order are the reference's (``jax.tree_util``'s paths:
  ``['key']`` for a dict key, dict keys sorted, ``.field`` for a named
  tuple's field), so a checkpoint written by the JAX package restores into
  the port's tree of the same structure, and the other way round.
* ``save_async`` copies every leaf to the host first, then writes on a
  background thread: the train loop does not wait for the disk.
* ``keep_n`` keeps the newest steps and deletes the rest.
* bf16 leaves are stored as their uint16 bits (numpy has no bf16) under
  the dtype name ``bfloat16``.
* A mesh's sharded leaf (``core.placement.Sharded``) is saved as its
  logical array, so a checkpoint does not depend on the mesh it was
  written from, and the reference's manager reads it.
* ``restore(..., sharding=)`` places every leaf by one sharding or by a
  tree of them (``core.placement.place``): the elastic path, where a
  checkpoint saved on mesh A loads onto mesh B.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.placement import Sharded, place_tree


def _flatten(tree: Any, path: str = ""):
    """(name, leaf) pairs in the reference's leaf order and naming."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}/['{k}']" if path else f"['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{path}/.{f}" if path else f".{f}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _flatten(t, f"{path}/[{i}]" if path else f"[{i}]")
    else:
        yield path, tree


def _rebuild(like: Any, fn) -> Any:
    """``like``'s structure with each leaf x replaced by fn(x), called in
    ``_flatten``'s leaf order."""
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], fn) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), fn) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(t, fn) for t in like)
    return fn(like)


def _to_host(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = x.full()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().copy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, (torch.Tensor, Sharded)):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep_n = keep_n
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> str:
        names, leaves = zip(*_flatten(tree)) if tree else ((), ())
        dtypes = [_dtype_name(x) for x in leaves]
        host = [_to_host(x) for x in leaves]  # device → host copy, now
        if blocking:
            return self._write(step, list(names), host, dtypes)
        self.wait()  # at most one save in flight
        self._thread = threading.Thread(
            target=self._write, args=(step, list(names), host, dtypes), daemon=True
        )
        self._thread.start()
        return self._path(step)

    def save_async(self, step: int, tree: Any) -> str:
        return self.save(step, tree, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _write(self, step: int, names: list[str], leaves: list[np.ndarray],
               dtypes: list[str]) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_p{self.process_index}.npz"),
                 **{f"a{i}": x for i, x in enumerate(leaves)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": dtypes,
            "process_count": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, sharding: Any = None) -> Any:
        """The checkpoint of ``step`` in the structure of ``like``, each
        leaf a tensor with ``like``'s leaf's dtype on its device (a Sharded
        leaf's: its first piece's).  ``sharding``: a NamedSharding for every
        leaf, or a tree of them matching ``like``, to place the leaves by —
        the elastic path: a checkpoint saved on mesh A loads onto mesh B by
        passing B's shardings here."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        names = [n for n, _ in _flatten(like)]
        if names != manifest["names"]:
            raise ValueError(
                f"checkpoint tree mismatch: {set(names) ^ set(manifest['names'])}"
            )
        data = np.load(os.path.join(path, f"shard_p{self.process_index}.npz"))
        arrays = ((data[f"a{i}"], dt) for i, dt in enumerate(manifest["dtypes"]))

        def load(ref):
            a, dt = next(arrays)
            if dt == "bfloat16":
                t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            if isinstance(ref, (torch.Tensor, Sharded)):
                return t.to(device=ref.device, dtype=ref.dtype)
            return t

        tree = _rebuild(like, load)
        return tree if sharding is None else place_tree(tree, sharding)
