"""Fault tolerance for training: the port of ``repro.runtime`` (failure
injection, the recovery loop, the straggler monitor and elastic
re-meshing)."""
from .elastic import replicated, reshard_tree
from .fault import FaultInjector, StragglerMonitor, run_with_recovery

__all__ = ["FaultInjector", "StragglerMonitor", "replicated", "reshard_tree",
           "run_with_recovery"]
