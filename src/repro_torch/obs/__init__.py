"""Unified observability: span tracing, event bus, metrics.

The port of the reference's ``repro.obs``.  Layering contract:
``repro_torch.obs`` imports nothing from ``repro_torch.core`` or
``repro_torch.service`` — every layer above threads its events *down*
into this package (``obs.instrument.instrument()`` is a window over the
same bus).
"""
from repro_torch.obs.metrics import REGISTRY, MetricsCollector, Registry
from repro_torch.obs.tracer import (Span, Tracer, current, emit, enabled,
                                    first_use, forget_use, load_chrome,
                                    register_collector, set_fault_hook,
                                    span, timed_dispatch, traced, tracing,
                                    unregister_collector)

# the default registry listens to every event for the life of the process
_METRICS = MetricsCollector(REGISTRY)
register_collector(_METRICS)

__all__ = [
    "REGISTRY", "MetricsCollector", "Registry", "Span", "Tracer",
    "current", "emit", "enabled", "first_use", "forget_use",
    "load_chrome", "register_collector", "set_fault_hook", "span",
    "timed_dispatch", "traced", "tracing", "unregister_collector",
]
