"""Fault tolerance for training: the port of ``repro.runtime`` (elastic
re-meshing waits for the multi-GPU slice, ROADMAP Queue 1 item 10)."""
from .fault import FaultInjector, StragglerMonitor, run_with_recovery

__all__ = ["FaultInjector", "StragglerMonitor", "run_with_recovery"]
