"""Observability: metrics registry + span tracing + retrieval introspection
(port of ``repro.obs``).

One :class:`Observability` bundle travels with a serving session: the
engine and the scheduler share its :class:`~repro_torch.obs.metrics.MetricsRegistry`
and its :class:`~repro_torch.obs.tracing.Tracer` (request-lifecycle spans
and scheduler events on the virtual token clock).  ``metrics.py`` and
``tracing.py`` are copies of the JAX package's (standard library only).
``introspect=True`` additionally attaches a
:class:`~repro_torch.obs.introspect.RetrievalIntrospector` that samples the
FIER retrieval stage per decode step (budget utilization, τ thresholds,
oracle overlap, recaptured attention mass) into the same registry.

The default is **disabled**: ``Observability.disabled()`` (what an engine
constructs when none is passed) hands out no-op instruments and the null
tracer.
"""
from __future__ import annotations

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    Snapshot,
    parse_prometheus_text,
)
from .tracing import (
    NULL_TRACER,
    Event,
    Tracer,
    derive_serving_metrics,
    load_trace_events,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Event",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Observability",
    "ProbeRecord",
    "RetrievalIntrospector",
    "Series",
    "Snapshot",
    "Tracer",
    "derive_serving_metrics",
    "load_trace_events",
    "parse_prometheus_text",
    "validate_chrome_trace",
]


# the introspector needs numpy and torch; metrics/tracing are stdlib-only,
# so it loads lazily
_INTROSPECT_NAMES = {"ProbeRecord", "RetrievalIntrospector"}


def __getattr__(name: str):
    if name in _INTROSPECT_NAMES:
        from . import introspect

        return getattr(introspect, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")


class Observability:
    """The per-session observability bundle: ``metrics`` + ``tracer``
    (+ optional ``introspector``).

    ``enabled`` turns both the registry and the tracer on; pass
    ``introspect=True`` (it needs ``enabled``) to attach the
    retrieval-quality debug probe.  ``metrics`` shares an existing registry
    between sessions.
    """

    def __init__(self, enabled: bool = True, *, introspect: bool = False,
                 probe_layer: int = 0, probe_every: int = 1,
                 metrics: MetricsRegistry | None = None):
        self.enabled = enabled
        self.metrics = (metrics if metrics is not None
                        else MetricsRegistry(enabled=enabled))
        self.tracer: Tracer = Tracer() if enabled else NULL_TRACER
        self.introspector = None
        if enabled and introspect:
            from .introspect import RetrievalIntrospector

            self.introspector = RetrievalIntrospector(
                self.metrics, self.tracer, probe_layer=probe_layer, every=probe_every,
            )

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(enabled=False)

    def __repr__(self) -> str:
        return (f"Observability(enabled={self.enabled}, "
                f"introspect={self.introspector is not None})")
