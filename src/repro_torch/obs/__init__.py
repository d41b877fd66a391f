"""Observability: metrics registry + span tracing (port of ``repro.obs``).

One :class:`Observability` bundle travels with a serving session: the
engine and the scheduler share its :class:`~repro_torch.obs.metrics.MetricsRegistry`
and its :class:`~repro_torch.obs.tracing.Tracer` (request-lifecycle spans
and scheduler events on the virtual token clock).  ``metrics.py`` and
``tracing.py`` are copies of the JAX package's (standard library only).

The default is **disabled**: ``Observability.disabled()`` (what an engine
constructs when none is passed) hands out no-op instruments and the null
tracer.  The retrieval introspector (``introspect=True``) is not ported
yet and raises.
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
    "Series",
    "Snapshot",
    "Tracer",
    "derive_serving_metrics",
    "load_trace_events",
    "parse_prometheus_text",
    "validate_chrome_trace",
]


class Observability:
    """The per-session observability bundle: ``metrics`` + ``tracer``.

    ``enabled`` turns both the registry and the tracer on; ``metrics``
    shares an existing registry between sessions.  ``introspector`` is
    always None in the port (the scheduler checks it).
    """

    def __init__(self, enabled: bool = True, *, introspect: bool = False,
                 metrics: MetricsRegistry | None = None):
        if introspect:
            raise NotImplementedError(
                "the retrieval introspector is not ported yet "
                "(ROADMAP Queue 1 item 8)"
            )
        self.enabled = enabled
        self.metrics = (metrics if metrics is not None
                        else MetricsRegistry(enabled=enabled))
        self.tracer: Tracer = Tracer() if enabled else NULL_TRACER
        self.introspector = None

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(enabled=False)

    def __repr__(self) -> str:
        return f"Observability(enabled={self.enabled})"
