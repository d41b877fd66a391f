"""Elastic re-meshing: move a state tree onto a different mesh (port of
``repro.runtime.elastic``).

After losing devices, the surviving pool forms a smaller mesh; params and
optimizer state placed under mesh A's shardings must re-shard to mesh B.
The cold path restores a checkpoint with the new mesh's shardings
(``CheckpointManager.restore(..., sharding=)``); ``reshard_tree`` is the
warm path (state still resident).  The train launcher composes it with
``run_with_recovery``: its ``on_restore`` re-places the restored tree on
the mesh.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.placement import NamedSharding, P, place_tree
from repro_torch.launch.mesh import Mesh


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Place every leaf onto its (possibly new-mesh) sharding: ``shardings``
    is a tree matching ``tree`` or one NamedSharding for every leaf.  A
    Sharded leaf is re-placed through its logical tensor."""
    return place_tree(tree, shardings)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
