"""MetricsRegistry: one publish surface, one flush point, degraded failures
(the port's copy of ``llmtrain_tpu/telemetry/registry.py``).

Losing a metrics sample must cost a warning, never a training run. The
registry is the indirection that buys that:

* components (trainer, scheduler, HTTP handlers) call :meth:`publish` /
  :meth:`inc` / :meth:`observe` freely — pure dict work, cannot fail;
* :meth:`flush` pushes the pending sample to the tracker ONCE per log
  interval inside a try/except that degrades to a rate-limited warning
  and an error counter (``telemetry/tracker_errors``); the tracker's
  params and artifacts go through :meth:`safe_log_params` and
  :meth:`safe_log_artifact` under the same stance;
* the last value of every metric stays readable via :meth:`latest` —
  what the Prometheus renderer scrapes and the run report aggregates, so
  observability keeps working while the tracker backend is down.

Serving builds it without a tracker (``MetricsRegistry()``) and never
flushes: its gauges, counters and histograms feed ``GET /metrics``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any

from ..tracking.base import Tracker
from ..utils.logging import get_logger
from .stats import Histogram

logger = get_logger()

# Re-warn cadence while a tracker stays broken: the first failure warns,
# then every Nth, so a dead mlflow server doesn't turn the log into noise.
_REWARN_EVERY = 50

# Metric keys whose per-flush history feeds the end-of-run report's
# trajectory section (bounded deque; everything else keeps latest only).
_HISTORY_KEYS = (
    "train/loss",
    "val/loss",
    "train/tokens_per_sec",
    "train/mfu",
    "mem/hbm_used",
)


class MetricsRegistry:
    """Buffered metric publication with a degrade-to-warning tracker flush."""

    def __init__(
        self, tracker: Tracker | None = None, *, history_len: int = 2048
    ) -> None:
        self._tracker = tracker
        self._lock = threading.Lock()
        self._pending: dict[str, float] = {}
        self._latest: dict[str, tuple[float, int | None]] = {}
        self._counters: dict[str, float] = {}
        self._history: deque[tuple[int | None, dict[str, float]]] = deque(
            maxlen=history_len
        )
        self._histograms: dict[str, Any] = {}
        self._error_streak = 0
        self._total_errors = 0

    # -------------------------------------------------------------- publish

    def publish(self, metrics: dict[str, float], step: int | None = None) -> None:
        """Buffer a metrics sample for the next flush (last write wins per
        key within an interval). Also updates the live values immediately
        so Prometheus scrapes between flushes see fresh data."""
        if not metrics:
            return
        with self._lock:
            for key, value in metrics.items():
                value = float(value)
                self._pending[key] = value
                self._latest[key] = (value, step)

    def inc(self, name: str, by: float = 1.0) -> None:
        """Monotonic event counter (rollbacks, faults, tracker errors...)."""
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
        """Record one sample into a named fixed-bucket histogram.

        First call per name creates the histogram with ``buckets``
        (subsequent calls reuse it; changing the bucket layout of a live
        metric mid-run is not a thing Prometheus can represent anyway).
        ``trace_id`` attaches an exemplar to the bucket the sample lands
        in — the dashboard→trace link.
        """
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram(buckets)
        hist.observe(value, trace_id=trace_id, unix_time=unix_time)

    # ---------------------------------------------------------------- flush

    def flush(self, step: int | None = None) -> bool:
        """Push the pending sample to the tracker; True when it landed.

        Failures NEVER propagate: the step loop calling this must survive
        any tracker backend state."""
        with self._lock:
            sample = dict(self._pending)
            self._pending.clear()
            if sample:
                row = {k: sample[k] for k in _HISTORY_KEYS if k in sample}
                if row:
                    self._history.append((step, row))
        if not sample or self._tracker is None:
            return bool(sample)
        try:
            self._tracker.log_metrics(sample, step=step)
        except Exception as exc:  # noqa: BLE001 — degrade, never kill the run
            self._error_streak += 1
            self._total_errors += 1
            self.inc("telemetry/tracker_errors")
            if self._error_streak == 1 or self._error_streak % _REWARN_EVERY == 0:
                logger.warning(
                    "tracker log_metrics failed (%s failure%s in a row): %s — "
                    "continuing without it; metrics stay available via the "
                    "telemetry registry/Prometheus endpoint",
                    self._error_streak,
                    "" if self._error_streak == 1 else "s",
                    exc,
                )
            return False
        if self._error_streak:
            logger.info(
                "tracker recovered after %d failed flush(es)", self._error_streak
            )
        self._error_streak = 0
        return True

    # -------------------------------------------- safe non-metric passthrough

    def safe_log_params(self, params: dict[str, Any]) -> bool:
        return self._safe("log_params", params)

    def safe_log_artifact(self, local_path: str, artifact_path: str | None = None) -> bool:
        return self._safe("log_artifact", local_path, artifact_path)

    def _safe(self, method: str, *args: Any) -> bool:
        """Tracker call with the same degrade-to-warning stance as flush."""
        if self._tracker is None:
            return False
        try:
            getattr(self._tracker, method)(*args)
            return True
        except Exception as exc:  # noqa: BLE001
            self._total_errors += 1
            self.inc("telemetry/tracker_errors")
            logger.warning("tracker %s failed: %s — continuing", method, exc)
            return False

    # ---------------------------------------------------------------- reads

    def latest(self) -> dict[str, tuple[float, int | None]]:
        with self._lock:
            return dict(self._latest)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def histograms(self) -> dict[str, Any]:
        """Live :class:`~.stats.Histogram` objects by metric name (the
        objects are thread-safe; renderers snapshot them)."""
        with self._lock:
            return dict(self._histograms)

    def history(self) -> list[tuple[int | None, dict[str, float]]]:
        with self._lock:
            return list(self._history)

    @property
    def tracker_errors(self) -> int:
        return self._total_errors


__all__ = ["MetricsRegistry"]
