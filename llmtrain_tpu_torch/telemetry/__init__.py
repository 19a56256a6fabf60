"""Serving telemetry: metrics registry, latency statistics, Prometheus text."""
