"""Prometheus exposition: text rendering, stdlib HTTP endpoint, textfile
(the port's copy of ``llmtrain_tpu/telemetry/prometheus.py``).

Two transports, both fed from the same render:

* :class:`PrometheusEndpoint` — a tiny stdlib ``ThreadingHTTPServer``
  (daemon threads, no dependencies) serving ``GET /metrics``. Config-gated
  (``telemetry.prometheus``) and started on EVERY process of a training
  job; processes sharing one network namespace race for the bind and the
  loser degrades to a warning (``Telemetry.start``). Serving's own
  ``GET /metrics`` renders through :func:`render_prometheus` too.
* **textfile fallback** — ``{run_dir}/telemetry/metrics.prom`` rewritten
  atomically at every flush (:func:`write_textfile`), for node-exporter's
  textfile collector.

Naming convention: metric names map ``train/loss`` → ``llmtrain_train_loss``
— one ``llmtrain_`` namespace, non-alphanumerics folded to ``_``.
:func:`federate_prometheus` merges the fleet's per-tenant texts into one
scrape (fleet/supervisor.py).
"""

from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable

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


# Quote-aware label block: a `}` or `#` inside a quoted label value
# (escapes included) doesn't terminate it, so a value that happens to
# contain ` # {` still parses as one label set.
_LABELS_PAT = r"\{(?:[^\"{}]|\"(?:[^\"\\]|\\.)*\")*\}"
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    rf"(?P<labels>{_LABELS_PAT})?"
    r"\s+(?P<value>\S+)"
    # Optional OpenMetrics exemplar suffix — ` # {trace_id="..."} 212.4`
    # (see render_histogram) — anchored AFTER the sample value so it can
    # only ever match a real exemplar, never label-value content.
    rf"(?:\s+#\s+{_LABELS_PAT}\s+\S+(?:\s+\S+)?)?"
    r"\s*$"
)
_TYPE_RE = re.compile(r"^#\s*TYPE\s+(?P<name>\S+)\s+(?P<type>\S+)\s*$")


def federate_prometheus(sources: dict[str, str]) -> str:
    """Merge per-tenant exposition texts into ONE scrape payload.

    The fleet supervisor runs tenants as subprocesses whose own
    ``/metrics`` ports are ephemeral (or textfile-only); a cluster
    scraper should not have to discover N moving targets. This re-emits
    every tenant series with a ``tenant="<name>"`` label injected (merged
    in front of any existing labels) and additionally rolls counters up
    into an unlabeled fleet-wide sum, so ``llmtrain_*_total`` without a
    selector reads as "the whole fleet".

    ``sources`` maps tenant name → that tenant's exposition text (e.g.
    the content of its ``telemetry/metrics.prom`` textfile). Unparseable
    lines are dropped, not propagated — one corrupt tenant file must not
    poison the fleet scrape.
    """
    types: dict[str, str] = {}
    series: dict[str, list[str]] = {}
    counter_sums: dict[str, float] = {}
    for tenant in sorted(sources):
        tenant_label = f'tenant="{_escape_label(tenant)}"'
        for line in sources[tenant].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                m = _TYPE_RE.match(line)
                if m:
                    types.setdefault(m.group("name"), m.group("type"))
                continue
            # Exemplar suffixes (`... # {trace_id="..."} 1.2`) are valid
            # OpenMetrics but not part of the sample proper — _SAMPLE_RE
            # accepts-and-ignores them so histogram buckets federate
            # (without the exemplar) instead of being dropped.
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, labels, value = m.group("name"), m.group("labels"), m.group("value")
            inner = (labels or "{}")[1:-1].strip()
            merged = tenant_label + ("," + inner if inner else "")
            series.setdefault(name, []).append(f"{name}{{{merged}}} {value}")
            if types.get(name) == "counter":
                try:
                    counter_sums[name] = counter_sums.get(name, 0.0) + float(value)
                except ValueError:
                    pass
    lines: list[str] = []
    for name in sorted(series):
        lines.append(f"# TYPE {name} {types.get(name, 'gauge')}")
        lines.extend(series[name])
        if name in counter_sums:
            lines.append(f"{name} {_fmt_value(counter_sums[name])}")
    return "\n".join(lines) + "\n" if lines else ""


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


class _Handler(BaseHTTPRequestHandler):
    # the provider closure is injected per-server via the factory below
    provider: Callable[[], str]

    def do_GET(self) -> None:  # noqa: N802 - stdlib naming
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = self.provider().encode("utf-8")
        except Exception as exc:  # noqa: BLE001 — a scrape must not crash training
            self.send_error(500, explain=str(exc)[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        # Scrapes arrive every few seconds; stdout noise helps nobody.
        pass


class PrometheusEndpoint:
    """Config-gated ``/metrics`` HTTP server on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is readable
    via :attr:`port`. Construction failures (port taken, no permission)
    raise — the caller (Telemetry facade) degrades them to a warning so a
    busy port never kills a training run.
    """

    def __init__(
        self,
        provider: Callable[[], str],
        *,
        host: str = "0.0.0.0",
        port: int = 9200,
    ) -> None:
        handler = type("BoundHandler", (_Handler,), {"provider": staticmethod(provider)})
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="prometheus-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._server.server_address[1])

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass
        self._thread.join(timeout=5.0)


__all__ = [
    "PrometheusEndpoint",
    "federate_prometheus",
    "prometheus_name",
    "render_histogram",
    "render_prometheus",
    "write_textfile",
]
