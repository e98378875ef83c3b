"""Observability (counterpart of ``repro.obs``): request-lifecycle spans
(``trace``) on an injectable clock (``clock``), the process-wide metrics
registry with JSONL and Prometheus exporters (``metrics``), the shared
sinks (``sink``) and the in-graph numerics telemetry (``ingraph``).

Everything is opt-in: with no tracer or registry given, the instrumented
engines run exactly as without them."""

from repro_torch.obs.clock import Clock, SystemClock, VirtualClock
from repro_torch.obs.metrics import (
    MetricsRegistry,
    collect_process_metrics,
    get_registry,
    record_controller_events,
    record_spec_events,
    set_registry,
)
from repro_torch.obs.sink import JsonlSink, RingBuffer, jsonl_append
from repro_torch.obs.trace import (
    Span,
    Tracer,
    percentile,
    request_latencies,
    span_forest,
)

__all__ = [
    "Clock", "SystemClock", "VirtualClock",
    "MetricsRegistry", "get_registry", "set_registry",
    "collect_process_metrics", "record_controller_events",
    "record_spec_events",
    "JsonlSink", "RingBuffer", "jsonl_append",
    "Span", "Tracer", "span_forest", "request_latencies", "percentile",
]
