"""Observability (counterpart of ``repro.obs``): the JSONL sink and the
in-graph numerics telemetry; tracing and the metrics registry are not
ported yet."""
