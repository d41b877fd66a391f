"""Serving: the engine (slab and paged layouts) and the continuous-batching
scheduler."""
from .engine import Engine, PoolExhausted, SamplingConfig, sample_token, serving_policy
from .health import HealthMonitor, RequestOutcome, ServeResult, StepReport
from .scheduler import ContinuousScheduler, Request

__all__ = [
    "ContinuousScheduler", "Engine", "HealthMonitor", "PoolExhausted", "Request",
    "RequestOutcome", "SamplingConfig", "ServeResult", "StepReport", "sample_token",
    "serving_policy",
]
