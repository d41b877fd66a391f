"""Serving: the slab-cache engine (``ContinuousScheduler`` comes with the
next slice)."""
from .engine import Engine, SamplingConfig, sample_token, serving_policy

__all__ = ["Engine", "SamplingConfig", "sample_token", "serving_policy"]
