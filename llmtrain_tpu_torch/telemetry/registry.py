"""MetricsRegistry: the publish surface serving reads ``/metrics`` from.

Port of ``llmtrain_tpu/telemetry/registry.py`` reduced to what serving
uses: live gauges (:meth:`publish`, read by :meth:`latest`), monotonic
counters (:meth:`inc`) and fixed-bucket histograms (:meth:`observe`). The
tracker flush and run history are not ported (ROADMAP.md queue A:
telemetry). Every method is thread-safe: the scheduler and HTTP handler
threads record while the scrape handler reads.
"""

from __future__ import annotations

import threading
from typing import Any

from .stats import Histogram


class MetricsRegistry:
    """Live metric values behind one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._latest: dict[str, tuple[float, int | None]] = {}
        self._counters: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}

    def publish(self, metrics: dict[str, float]) -> None:
        """Set live gauge values (last write wins; no step: serving gauges
        are not per training step)."""
        with self._lock:
            for key, value in metrics.items():
                self._latest[key] = (float(value), None)

    def inc(self, name: str, by: float = 1.0) -> None:
        """Monotonic event counter."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def observe(
        self,
        name: str,
        value: float,
        *,
        buckets: tuple[float, ...],
        trace_id: str | None = None,
        unix_time: float | None = None,
    ) -> None:
        """Record one sample into a named fixed-bucket histogram, created
        with ``buckets`` on first use."""
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram(buckets)
        hist.observe(value, trace_id=trace_id, unix_time=unix_time)

    def latest(self) -> dict[str, tuple[float, int | None]]:
        with self._lock:
            return dict(self._latest)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def histograms(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._histograms)

    # The report reads these (telemetry/report.py). With no tracker flush
    # ported there is no per-flush history and no flush can fail — what a
    # JAX registry holds in a serving process, which never flushes.
    tracker_errors = 0

    def history(self) -> list[tuple[int | None, dict[str, float]]]:
        return []


__all__ = ["MetricsRegistry"]
