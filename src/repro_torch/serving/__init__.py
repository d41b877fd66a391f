"""Serving: the engine (slab and paged layouts, the host offload tier), the
continuous-batching scheduler and its deterministic fault injector."""
from .engine import Engine, PoolExhausted, SamplingConfig, sample_token, serving_policy
from .faults import FAULT_KINDS, FaultSpec, ServingFaultInjector
from .health import HealthMonitor, RequestOutcome, ServeResult, StepReport
from .scheduler import ContinuousScheduler, Request

__all__ = [
    "FAULT_KINDS", "ContinuousScheduler", "Engine", "FaultSpec", "HealthMonitor",
    "PoolExhausted", "Request", "RequestOutcome", "SamplingConfig", "ServeResult",
    "ServingFaultInjector", "StepReport", "sample_token", "serving_policy",
]
