"""Fault tolerance for training: the port of ``repro.runtime`` (elastic
re-meshing waits for ROADMAP Queue 1 item 10's training part)."""
from .fault import FaultInjector, StragglerMonitor, run_with_recovery

__all__ = ["FaultInjector", "StragglerMonitor", "run_with_recovery"]
