"""Unified telemetry subsystem (the port's copy of
``llmtrain_tpu/telemetry/__init__.py``): timeline, metrics registry,
memory, Prometheus export, end-of-run reports, request tracing.

One facade (:class:`Telemetry`) owns the pieces and their lifecycle so the
trainer wires a single object:

* :class:`~.timeline.EventTimeline` — structured span/instant stream,
  JSONL + Perfetto export, aligned with ``torch.profiler`` windows;
* :class:`~.registry.MetricsRegistry` — the one publish surface, flushed
  to the tracker once per log interval with failures degraded to
  warnings;
* :class:`~.memory.MemoryMonitor` — device/host memory accounting with a
  headroom warning channel;
* :class:`~.prometheus.PrometheusEndpoint` — config-gated ``/metrics``
  HTTP server + textfile fallback;
* :mod:`~.report` — ``report.json`` / ``report.md`` aggregation, with the
  goodput ledger (:mod:`~.goodput`) and the cost attribution
  (:mod:`~.profiling`).

Rank discipline: every rank records in memory, but FILE outputs (JSONL,
trace, report, textfile) are main-process-only — non-main ranks share the
run dir read-only. The metrics endpoint starts on every process. The
process index and main-ness come from the data-parallel group
(``distributed.active_state()``) unless given.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

import torch

from ..distributed import active_state
from ..tracking.base import Tracker
from ..utils.logging import get_logger
from .memory import MemoryMonitor
from .prometheus import (
    PrometheusEndpoint,
    prometheus_name,
    render_prometheus,
    write_textfile,
)
from .registry import MetricsRegistry
from .report import build_report, render_markdown, write_reports
from .stats import percentile, percentiles
from .timeline import EventTimeline, step_annotation
from .tracing import TailSampler, TraceContext, Tracer

logger = get_logger()

# Cap on individual files registered as tracker artifacts per pattern walk
# (a profiler window can emit hundreds of tool files).
_ARTIFACT_CAP = 64


class Telemetry:
    """Facade tying the telemetry pieces to one run's lifecycle.

    ``cfg`` is the full RunConfig (the facade reads ``cfg.telemetry`` and
    run identity). Pass ``run_dir=None`` (or ``is_main=False``) for a
    memory-only instance — every method stays callable. ``process_index``
    and ``is_main`` default to the data-parallel group's (rank 0 of one
    process without a group); ``device`` is the run's, whose allocator the
    memory monitor reads (the CPU when None).
    """

    def __init__(
        self,
        cfg: Any,
        run_dir: str | Path | None,
        tracker: Tracker | None,
        *,
        process_index: int | None = None,
        is_main: bool | None = None,
        device: torch.device | None = None,
    ) -> None:
        dist = active_state()
        if process_index is None:
            process_index = dist.process_index if dist is not None else 0
        if is_main is None:
            is_main = dist is None or dist.is_main
        self._cfg = cfg.telemetry
        self._run_name = cfg.run.name
        self._run_dir = Path(run_dir) if run_dir is not None else None
        self._is_main = is_main
        self._process_index = process_index
        self._writes_files = (
            self._cfg.enabled and is_main and self._run_dir is not None
        )
        telemetry_dir = (
            self._run_dir / "telemetry" if self._run_dir is not None else None
        )
        self._dir = telemetry_dir

        record_timeline = self._cfg.enabled and self._cfg.timeline
        self.timeline = EventTimeline(
            (telemetry_dir / "timeline.jsonl")
            if self._writes_files and self._cfg.timeline
            else None,
            process_index=process_index,
            max_events=self._cfg.max_events,
            xprof_annotations=record_timeline and self._cfg.xprof_annotations,
            # enabled=False -> every span/instant is a true no-op: the
            # master switch must remove the subsystem from the hot path,
            # not just its file outputs.
            enabled=record_timeline,
        )
        # The registry keeps the tracker even with telemetry disabled:
        # the trainer routes ALL tracker traffic through it, so severing
        # it here would turn `telemetry.enabled: false` into "no mlflow
        # logging at all" — the registry is plumbing, not telemetry.
        self.metrics = MetricsRegistry(tracker)
        self.memory = (
            MemoryMonitor(
                headroom_warn_frac=self._cfg.hbm_headroom_warn_frac,
                timeline=self.timeline,
                device=device,
            )
            if self._cfg.enabled and self._cfg.memory
            else None
        )
        self._endpoint: PrometheusEndpoint | None = None
        self._started = time.perf_counter()
        self._finalized = False
        # Last timeline-overflow total surfaced to the registry: flush()
        # publishes deltas so telemetry/timeline_dropped renders as a
        # Prometheus counter (llmtrain_telemetry_timeline_dropped_total)
        # and the report can warn that the goodput ledger may be lossy.
        self._dropped_reported = 0

    # -------------------------------------------------------------- lifecycle

    def step_annotation(self, step: int):
        """``torch.profiler`` step region honoring the config gate."""
        return step_annotation(
            step, enabled=self._cfg.enabled and self._cfg.xprof_annotations
        )

    def start(self) -> None:
        """Arm the run-scoped transports (Prometheus endpoint). Failures
        degrade to warnings — a busy port must not kill a training run.

        The endpoint starts on EVERY process, not just main: on k8s each
        pod has its own IP and the scrape annotation covers all of them,
        and non-main ranks serve genuinely per-host data (mem/*, span
        counters). Two ranks sharing one network namespace (local
        multi-process testing) simply lose the second bind to the
        degrade-to-warning path."""
        self._started = time.perf_counter()
        if not (self._cfg.enabled and self._cfg.prometheus):
            return
        if self._endpoint is not None:
            return
        try:
            self._endpoint = PrometheusEndpoint(
                self._render_prometheus,
                host=self._cfg.prometheus_host,
                port=self._cfg.prometheus_port,
            )
            logger.info(
                "prometheus metrics endpoint listening on %s:%d (/metrics)",
                self._cfg.prometheus_host,
                self._endpoint.port,
            )
        except OSError as exc:
            logger.warning(
                "prometheus endpoint failed to bind %s:%d (%s); continuing "
                "with the textfile fallback only",
                self._cfg.prometheus_host,
                self._cfg.prometheus_port,
                exc,
            )

    @property
    def prometheus_port(self) -> int | None:
        """Bound /metrics port, or None when the endpoint is not serving."""
        return self._endpoint.port if self._endpoint is not None else None

    def _render_prometheus(self) -> str:
        return render_prometheus(
            self.metrics.latest(),
            self.metrics.counters(),
            info={
                "run_name": self._run_name,
                "process_index": str(self._process_index),
            },
        )

    def record_opt_state_bytes(self, info: dict[str, float]) -> None:
        """Static optimizer-state footprint: lands in the report's memory
        block AND as ``mem/*`` gauges. Gated with the memory monitor — the
        telemetry master switch removes ALL ``mem/*`` traffic, accounting
        included."""
        if self.memory is None:
            return
        self.memory.record_opt_state(info)
        self.metrics.publish({f"mem/{k}": float(v) for k, v in info.items()})

    def record_activation_bytes(self, info: dict[str, float]) -> None:
        """Analytic activation footprint: ``activation_bytes``
        device-resident + ``activation_bytes_offloaded`` host-staged, into
        the report's memory block AND as ``mem/*`` gauges — same contract
        as the opt-state accounting above."""
        if self.memory is None:
            return
        self.memory.record_activations(info)
        self.metrics.publish({f"mem/{k}": float(v) for k, v in info.items()})

    def flush(self, step: int | None = None) -> None:
        """The per-log-interval flush point: sample memory, push the pending
        metrics sample to the tracker (degraded on failure), persist the
        timeline, refresh the textfile snapshot.

        The registry flush runs even with telemetry disabled — it is how
        ALL tracker traffic flows now, and the master switch disables the
        telemetry extras, not experiment tracking."""
        if self.memory is not None:
            self.metrics.publish(self.memory.sample(step), step)
        self.metrics.flush(step)
        if not self._cfg.enabled:
            return
        self.timeline.flush()
        dropped = self.timeline.dropped
        if dropped > self._dropped_reported:
            self.metrics.inc(
                "telemetry/timeline_dropped", dropped - self._dropped_reported
            )
            self._dropped_reported = dropped
        if self._writes_files and self._cfg.prometheus_textfile:
            write_textfile(self._dir / "metrics.prom", self._render_prometheus())

    def finalize(
        self,
        train_result: dict[str, Any] | None = None,
        *,
        run_id: str | None = None,
        perf_attribution: dict[str, Any] | None = None,
        precision: dict[str, Any] | None = None,
    ) -> dict[str, Any] | None:
        """End-of-run: final flush, Perfetto export, report.json/report.md.

        ``perf_attribution`` is the cost-attribution block built by the
        caller (the trainer, via telemetry/profiling.py) — passed through
        to the report untouched.

        Returns the report dict (None when telemetry/reporting is off).
        Idempotent — a second call (e.g. an unwind path after the normal
        one) is a no-op.
        """
        if not self._cfg.enabled or self._finalized:
            return None
        self._finalized = True
        wall = time.perf_counter() - self._started
        self.flush()
        # Goodput ledger (telemetry/goodput.py): flush first so the JSONL
        # carries every event, stamp the clean-exit footer, THEN compute
        # post-hoc from the durable artifacts — the same numbers a
        # post-mortem `llmtrain goodput --run-dir` reads with this process
        # dead. Gauges publish before the final flush below so the
        # llmtrain_goodput_* family lands in the textfile snapshot.
        goodput = None
        if self._writes_files and self._cfg.timeline:
            self.timeline.end_segment()
            try:
                from .goodput import compute_goodput, goodput_gauges

                goodput = compute_goodput(self._run_dir)
                if goodput is not None:
                    self.metrics.publish(goodput_gauges(goodput))
                    self.flush()
            except Exception as exc:  # noqa: BLE001 — reporting must not fail the run
                logger.warning("goodput ledger computation failed: %s", exc)
        if self._writes_files and self._cfg.timeline:
            self.timeline.export_perfetto(self._dir / "trace.json")
        report = None
        if self._cfg.report:
            report = build_report(
                run_id=run_id or self._run_name,
                run_name=self._run_name,
                registry=self.metrics,
                timeline=self.timeline,
                memory=self.memory,
                wall_time_sec=wall,
                train_result=train_result,
                perf_attribution=perf_attribution,
                precision=precision,
                goodput=goodput,
            )
            if self._writes_files:
                write_reports(self._run_dir, report)
        return report

    def register_artifacts(self) -> None:
        """Register the run's telemetry + diagnostic files with the tracker
        (degrade-to-warning): report, trace, metrics snapshot, profiler
        traces, and any hang reports. Main process only."""
        if not (self._writes_files and self._run_dir is not None):
            return
        candidates: list[tuple[Path, str | None]] = [
            (self._run_dir / "report.json", None),
            (self._run_dir / "report.md", None),
        ]
        if self._dir is not None:
            candidates += [
                (self._dir / "trace.json", "telemetry"),
                (self._dir / "timeline.jsonl", "telemetry"),
                (self._dir / "metrics.prom", "telemetry"),
            ]
        for report_path in sorted(self._run_dir.glob("hang_report_*.txt"))[
            :_ARTIFACT_CAP
        ]:
            candidates.append((report_path, "diagnostics"))
        profile_dir = self._run_dir / "logs" / "profile"
        if profile_dir.is_dir():
            profile_files = sorted(
                p for p in profile_dir.rglob("*") if p.is_file()
            )
            if len(profile_files) > _ARTIFACT_CAP:
                logger.info(
                    "registering %d of %d profiler files as artifacts (cap)",
                    _ARTIFACT_CAP,
                    len(profile_files),
                )
            for p in profile_files[:_ARTIFACT_CAP]:
                rel = p.parent.relative_to(profile_dir).as_posix()
                candidates.append(
                    (p, "profile" if rel == "." else f"profile/{rel}")
                )
        for path, artifact_path in candidates:
            if path.is_file():
                self.metrics.safe_log_artifact(str(path), artifact_path)

    def close(self) -> None:
        """Release transports; safe to call multiple times / without start."""
        if self._endpoint is not None:
            self._endpoint.close()
            self._endpoint = None
        self.timeline.flush()


__all__ = [
    "EventTimeline",
    "MemoryMonitor",
    "MetricsRegistry",
    "PrometheusEndpoint",
    "TailSampler",
    "Telemetry",
    "TraceContext",
    "Tracer",
    "build_report",
    "percentile",
    "percentiles",
    "prometheus_name",
    "render_markdown",
    "render_prometheus",
    "step_annotation",
    "write_reports",
    "write_textfile",
]
