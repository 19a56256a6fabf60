"""Prometheus exposition text (the port's copy of the renderer in
``llmtrain_tpu/telemetry/prometheus.py``).

Naming convention: metric names map ``serve/latency_ms`` →
``llmtrain_serve_latency_ms`` — one ``llmtrain_`` namespace,
non-alphanumerics folded to ``_``. Serving renders its ``GET /metrics``
through :func:`render_prometheus`, and ``serve --trace-dir`` snapshots the
same text to a textfile with :func:`write_textfile`; the scrape endpoint
and fleet federation are not ported (ROADMAP.md queue A: telemetry).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any

from ..utils.logging import get_logger

logger = get_logger()

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_PREFIX = "llmtrain_"


def prometheus_name(metric: str) -> str:
    """``train/loss`` → ``llmtrain_train_loss`` (idempotent on valid names)."""
    base = _NAME_RE.sub("_", metric.strip("/ "))
    base = re.sub(r"__+", "_", base).strip("_")
    if not base:
        base = "unnamed"
    if base[0].isdigit():
        base = "_" + base
    return base if base.startswith(_PREFIX) else _PREFIX + base


def _fmt_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(float(value))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_LABELED_RE = re.compile(r"^(?P<base>[^{]+)(?P<labels>\{.*\})$")


def _split_labels(metric: str) -> tuple[str, str]:
    """Registry keys may embed a label set (``serve/rejected{reason="x"}``
    — how per-reason counters share one Prometheus metric family). Split
    into (base metric, labels-or-empty); only the base gets name-folded."""
    m = _LABELED_RE.match(metric)
    if m is None:
        return metric, ""
    return m.group("base"), m.group("labels")


def render_histogram(name: str, histogram: Any) -> list[str]:
    """Exposition lines for one fixed-bucket histogram with exemplars.

    ``histogram`` is a :class:`~.stats.Histogram` (anything with its
    ``snapshot()`` shape). Exemplars use the OpenMetrics suffix syntax —
    ``..._bucket{le="250"} 17 # {trace_id="..."} 212.4`` — which links a
    dashboard's TTFT spike straight to the distributed trace that caused
    it (docs/observability.md); classic-format scrapers that reject the
    suffix can strip everything after `` # ``.
    """
    rows, total_sum, total_count = histogram.snapshot()
    pname = prometheus_name(name)
    lines = [f"# TYPE {pname} histogram"]
    for le, cum, exemplar in rows:
        le_str = "+Inf" if math.isinf(le) else _fmt_value(le)
        sample = f'{pname}_bucket{{le="{le_str}"}} {cum}'
        if exemplar is not None:
            sample += (
                f' # {{trace_id="{_escape_label(exemplar.trace_id)}"}}'
                f" {_fmt_value(exemplar.value)}"
            )
        lines.append(sample)
    lines.append(f"{pname}_sum {_fmt_value(total_sum)}")
    lines.append(f"{pname}_count {total_count}")
    return lines


def render_prometheus(
    gauges: dict[str, tuple[float, int | None]],
    counters: dict[str, float] | None = None,
    info: dict[str, str] | None = None,
    histograms: dict[str, Any] | None = None,
) -> str:
    """Render the registry's state as Prometheus exposition text.

    ``gauges`` is ``{tracker metric name: (value, step)}`` (the registry's
    :meth:`~.registry.MetricsRegistry.latest`); ``counters`` become
    ``counter``-typed series; ``info`` renders as the conventional
    ``llmtrain_run_info{...} 1`` labels-only metric; ``histograms`` maps
    metric name → :class:`~.stats.Histogram` (see :func:`render_histogram`).
    """
    lines: list[str] = []
    if info:
        labels = ",".join(
            f'{_NAME_RE.sub("_", k)}="{_escape_label(str(v))}"'
            for k, v in sorted(info.items())
        )
        lines.append("# TYPE llmtrain_run_info gauge")
        lines.append(f"llmtrain_run_info{{{labels}}} 1")
    # Labeled series (serve/rejected{reason="..."}) share one family:
    # emit one TYPE line per family, however many labeled samples.
    typed: set[str] = set()
    for metric in sorted(gauges):
        value, _step = gauges[metric]
        base, labels = _split_labels(metric)
        name = prometheus_name(base)
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {_fmt_value(value)}")
    typed.clear()
    for metric in sorted(counters or {}):
        base, labels = _split_labels(metric)
        name = prometheus_name(base) + "_total"
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{labels} {_fmt_value((counters or {})[metric])}")
    for metric in sorted(histograms or {}):
        lines.extend(render_histogram(metric, (histograms or {})[metric]))
    return "\n".join(lines) + "\n"


def write_textfile(path: str | Path, text: str) -> bool:
    """Atomic write (tmp + rename) of the textfile-collector snapshot; a
    scraper must never read a half-written file. Never raises."""
    target = Path(path)
    tmp = target.with_name(target.name + ".tmp")
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_text(text, encoding="utf-8")
        tmp.replace(target)
        return True
    except OSError as exc:
        logger.warning("prometheus textfile write to %s failed (%s)", target, exc)
        return False


__all__ = ["prometheus_name", "render_histogram", "render_prometheus", "write_textfile"]
