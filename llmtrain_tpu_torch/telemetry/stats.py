"""Shared latency statistics (the port's copy of
``llmtrain_tpu/telemetry/stats.py``): ONE nearest-rank percentile, one
histogram.

Before this module the repo had two subtly different percentile
implementations — ``serving/loadgen.py`` used ceil nearest-rank
(``s[ceil(q*n)-1]``) while ``serving/http.py`` used round-index
(``s[round(q*(n-1))]``) — so "p99" in a loadgen report and "p99" on the
``/healthz`` scrape could disagree on the exact same sample set. Every
consumer (loadgen, HTTP stats, promote lifecycle gates, the trace
summary) now goes through :func:`percentile` / :func:`percentiles`, which
implement the classic **nearest-rank** definition: the smallest sample
such that at least ``q`` of the distribution is ≤ it. Nearest-rank never
interpolates, so a reported p99 is always a latency that actually
happened — the property SLO gates rely on.

:class:`Histogram` is the fixed-bucket counterpart used for Prometheus
exposition with exemplars (docs/observability.md): cumulative ``le``
buckets, a running sum/count, and per-bucket *exemplars* — the trace_id
of the most recent observation that landed in each bucket — so a
dashboard spike links straight to the distributed trace that caused it.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Sequence

__all__ = ["Exemplar", "Histogram", "percentile"]

def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ALREADY SORTED sequence.

    ``q`` in (0, 1]; rank = ceil(q * n) clamped to [1, n]. Raises on an
    empty sequence — callers decide what "no data" means (loadgen emits
    ``{}``, the sampler treats it as "keep").
    """
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("percentile of empty sequence")
    rank = math.ceil(q * n)
    return float(sorted_samples[min(n - 1, max(0, rank - 1))])


@dataclass
class Exemplar:
    """The most recent observation that landed in a bucket, with the
    trace_id linking it to a distributed trace (OpenMetrics exemplars)."""

    trace_id: str
    value: float
    unix_time: float


class Histogram:
    """Fixed-bucket cumulative histogram with per-bucket exemplars.

    Thread-safe (serving records from HTTP handler threads while the
    scrape handler snapshots). Buckets are upper bounds; ``+Inf`` is
    implicit. ``observe`` is O(#buckets) with a short critical section —
    cheap enough for the per-request serving path.
    """

    def __init__(self, buckets: Sequence[float]) -> None:
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError("histogram buckets must be sorted and non-empty")
        self.buckets: tuple[float, ...] = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._exemplars: list[Exemplar | None] = [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(
        self,
        value: float,
        *,
        trace_id: str | None = None,
        unix_time: float | None = None,
    ) -> None:
        value = float(value)
        idx = len(self.buckets)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if trace_id is not None:
                self._exemplars[idx] = Exemplar(
                    trace_id, value, unix_time if unix_time is not None else 0.0
                )

    def snapshot(
        self,
    ) -> tuple[list[tuple[float, int, Exemplar | None]], float, int]:
        """``([(le, cumulative_count, exemplar), ...], sum, count)`` with a
        trailing ``(inf, total, exemplar)`` row for the ``+Inf`` bucket."""
        with self._lock:
            counts = list(self._counts)
            exemplars = list(self._exemplars)
            total_sum, total_count = self._sum, self._count
        rows: list[tuple[float, int, Exemplar | None]] = []
        cum = 0
        for i, ub in enumerate(self.buckets):
            cum += counts[i]
            rows.append((ub, cum, exemplars[i]))
        rows.append((math.inf, cum + counts[-1], exemplars[-1]))
        return rows, total_sum, total_count
