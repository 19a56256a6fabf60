"""Serving telemetry: metrics registry, latency statistics, Prometheus text,
the event timeline, request tracing, the run report and the trace
collector."""
