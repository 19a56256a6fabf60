"""Run report (the port's copy of ``llmtrain_tpu/telemetry/report.py``):
one ``report.json`` + one ``report.md`` per run.

The trainer writes them at the end of every fit (``Telemetry.finalize``)
and ``serve-bench`` under ``--out``. Contents: final/first/min loss and a
bounded loss trajectory, throughput (tokens/sec, MFU), memory peaks
(device + host RSS + estimator source), resilience event counts, the
wall-clock breakdown by timeline span, the goodput ledger
(telemetry/goodput.py) and the cost attribution (telemetry/profiling.py),
and serve-bench's ``serving`` block. The JSON and the Markdown are JAX's,
key for key and line for line.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any

from ..utils.logging import get_logger

logger = get_logger()

# Loss-trajectory samples kept in report.json: enough to plot the run's
# shape, bounded so a 1M-step run doesn't produce a 100 MB report.
_TRAJECTORY_CAP = 512


def _thin(rows: list[Any], cap: int = _TRAJECTORY_CAP) -> list[Any]:
    if len(rows) <= cap:
        return rows
    stride = -(-len(rows) // cap)
    thinned = rows[::stride]
    if rows and thinned[-1] != rows[-1]:
        thinned.append(rows[-1])
    return thinned


def build_report(
    *,
    run_id: str,
    run_name: str,
    registry: Any,  # MetricsRegistry
    timeline: Any,  # EventTimeline
    memory: Any | None,  # MemoryMonitor
    wall_time_sec: float,
    train_result: dict[str, Any] | None = None,
    serving: dict[str, Any] | None = None,
    perf_attribution: dict[str, Any] | None = None,
    precision: dict[str, Any] | None = None,
    goodput: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Aggregate the telemetry state into the report dict."""
    latest = registry.latest()
    counters = registry.counters()
    history = registry.history()

    loss_rows = [
        [step, row["train/loss"]]
        for step, row in history
        if "train/loss" in row and step is not None
    ]
    losses = [v for _, v in loss_rows]
    loss_block: dict[str, Any] = {
        "first_logged": losses[0] if losses else None,
        "final": losses[-1] if losses else None,
        "min": min(losses) if losses else None,
        "trajectory": _thin(loss_rows),
    }
    val_rows = [
        [step, row["val/loss"]]
        for step, row in history
        if "val/loss" in row and step is not None
    ]
    if val_rows:
        loss_block["val_final"] = val_rows[-1][1]
        loss_block["val_trajectory"] = _thin(val_rows)

    def latest_value(key: str) -> float | None:
        entry = latest.get(key)
        return entry[0] if entry is not None else None

    throughput = {
        "tokens_per_sec": latest_value("train/tokens_per_sec"),
        "mfu": latest_value("train/mfu"),
        "step_time_sec": latest_value("train/step_time_sec"),
        "data_wait_ms": latest_value("train/data_wait_ms"),
        "host_dispatch_ms": latest_value("train/host_dispatch_ms"),
        "tokens_total": latest_value("train/tokens_total"),
    }

    mem_block: dict[str, Any] = {}
    if memory is not None:
        mem_block = {k: v for k, v in memory.peaks().items()}
        mem_block["source"] = memory.source

    spans = timeline.span_totals()
    tracked_ms = sum(s["total_ms"] for s in spans.values())
    span_block = {
        name: {
            **stats,
            "frac_of_wall": (
                round(stats["total_ms"] / (wall_time_sec * 1e3), 4)
                if wall_time_sec > 0
                else 0.0
            ),
        }
        for name, stats in sorted(spans.items())
    }

    events = {
        "instants": timeline.event_counts(),
        "counters": counters,
        "tracker_errors": registry.tracker_errors,
        "timeline_events_dropped": timeline.dropped,
    }

    # Recovery totals, first-class (docs/robustness.md): "how many times
    # did this run die/rewind/re-shard" is the first question after any
    # incident, and burying it in the counters dict made it invisible.
    result = train_result or {}
    resilience_block = {
        "resumes": int(counters.get("resilience/resumes", 0)),
        "resume_count": (
            int(latest_value("resilience/resume_count") or 0)
            or int(counters.get("resilience/resumes", 0))
        ),
        "rollbacks": int(
            result.get("rollbacks", counters.get("resilience/rollbacks", 0)) or 0
        ),
        "elastic_reshards": int(counters.get("resilience/elastic_reshard", 0)),
        "checkpoint_commits": int(counters.get("checkpoint/commits", 0)),
        "nonfinite_skips": int(counters.get("resilience/nonfinite_skips", 0)),
        "preempted": bool(result.get("preempted", False)),
    }

    report = {
        "schema": "llmtrain-telemetry-report/1",
        "run": {"run_id": run_id, "name": run_name},
        "wall_clock": {
            "total_sec": round(wall_time_sec, 3),
            "tracked_span_sec": round(tracked_ms / 1e3, 3),
        },
        "loss": loss_block,
        "throughput": throughput,
        "memory": mem_block,
        "resilience": resilience_block,
        "spans": span_block,
        "events": events,
    }
    if serving is not None:
        # SLO block from the serving load harness (serving/loadgen.py):
        # TTFT/per-token percentiles, throughput, occupancy, KV-pool and
        # compile accounting — docs/serving.md documents the schema.
        report["serving"] = serving
    if perf_attribution is not None:
        # Cost-attribution block (telemetry/profiling.py): XLA-counted
        # flops/bytes per executable, roofline class, MFU reconciliation,
        # step-time split — docs/observability.md "Attribution and
        # rooflines" documents the schema.
        report["perf_attribution"] = perf_attribution
    if precision is not None:
        # Numerics provenance (docs/perf.md "Quantized matmul training"):
        # the EFFECTIVE dtypes/paths the run compiled with — compute and
        # param dtype, loss_impl (incl. the large-vocab auto-selection),
        # and the capability-resolved matmul_precision — so a throughput
        # number in this report can never be quoted without its numerics.
        report["precision"] = precision
    if goodput is not None:
        # Cross-segment wall-clock attribution (telemetry/goodput.py):
        # per-segment category table + run totals + goodput_frac, computed
        # from the durable timeline/manifest artifacts — docs/
        # observability.md "Goodput" documents the taxonomy.
        report["goodput"] = goodput
    if train_result is not None:
        report["train_result"] = train_result
    return report


def _fmt(value: Any) -> str:
    if value is None:
        return "—"
    if isinstance(value, float):
        # Diverged runs put nan/inf here, and this report is exactly the
        # artifact that must survive them (int(inf) raises OverflowError).
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "inf" if value > 0 else "-inf"
        if value == 0:
            return "0"
        if abs(value) >= 1e15:
            return f"{value:.3e}"
        if abs(value) >= 1000:
            return f"{value:,.1f}"
        return f"{value:.4g}"
    return str(value)


def _fmt_bytes(value: Any) -> str:
    """Byte quantities only — _fmt cannot know units, and rendering a
    token count as GiB (or 'GiB bytes') would mislabel the report."""
    if value is None:
        return "—"
    value = float(value)
    if not math.isfinite(value):
        return _fmt(value)
    for unit, scale in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(value) >= scale:
            return f"{value / scale:.2f} {unit}"
    return f"{value:.0f} B"


def render_markdown(report: dict[str, Any]) -> str:
    """Human rendering of :func:`build_report`'s dict."""
    run = report["run"]
    lines = [
        f"# Run report — {run['name']} ({run['run_id']})",
        "",
        f"Wall clock: {_fmt(report['wall_clock']['total_sec'])} s "
        f"(tracked in spans: {_fmt(report['wall_clock']['tracked_span_sec'])} s)",
        "",
        "## Loss",
        "",
    ]
    loss = report["loss"]
    lines.append(
        f"- train: first {_fmt(loss['first_logged'])} → final {_fmt(loss['final'])}"
        f" (min {_fmt(loss['min'])})"
    )
    if "val_final" in loss:
        lines.append(f"- val (final): {_fmt(loss['val_final'])}")
    lines += ["", "## Throughput", ""]
    tp = report["throughput"]
    lines.append(f"- tokens/sec: {_fmt(tp['tokens_per_sec'])}")
    lines.append(f"- MFU: {_fmt(tp['mfu'])}")
    lines.append(f"- step time: {_fmt(tp['step_time_sec'])} s")
    lines.append(
        f"- data wait: {_fmt(tp['data_wait_ms'])} ms/step, "
        f"host dispatch: {_fmt(tp['host_dispatch_ms'])} ms/step"
    )
    resil = report.get("resilience") or {}
    if resil:
        lines += ["", "## Recovery", ""]
        lines.append(
            f"- resumes: {resil.get('resume_count', 0)} "
            f"(this segment: {resil.get('resumes', 0)})"
        )
        lines.append(f"- rollbacks: {resil.get('rollbacks', 0)}")
        lines.append(f"- elastic reshards: {resil.get('elastic_reshards', 0)}")
        lines.append(
            f"- checkpoint commits: {resil.get('checkpoint_commits', 0)}"
        )
        if resil.get("preempted"):
            lines.append("- **preempted** (clean SIGTERM save)")
    mem = report.get("memory") or {}
    if mem:
        lines += ["", "## Memory", ""]
        lines.append(
            f"- HBM peak: {_fmt_bytes(mem.get('hbm_peak_bytes'))} "
            f"(source: {mem.get('source', 'unknown')})"
        )
        lines.append(f"- host RSS peak: {_fmt_bytes(mem.get('host_rss_peak_bytes'))}")
        if mem.get("opt_state_bytes") is not None:
            # ZeRO accounting (trainer.zero, docs/perf.md): per-device vs
            # total is the sharding win; host bytes appear under offload.
            line = (
                f"- optimizer state: {_fmt_bytes(mem['opt_state_bytes'])} total, "
                f"{_fmt_bytes(mem.get('opt_state_bytes_per_device'))} per device"
            )
            if mem.get("opt_state_bytes_host"):
                line += f", {_fmt_bytes(mem['opt_state_bytes_host'])} host-offloaded"
            lines.append(line)
        warns = int(mem.get("headroom_warnings") or 0)
        if warns:
            lines.append(f"- **headroom warnings: {warns}** (see timeline)")
    spans = report.get("spans") or {}
    if spans:
        lines += [
            "",
            "## Wall-clock by span",
            "",
            "| span | count | total ms | max ms | % of wall |",
            "|---|---:|---:|---:|---:|",
        ]
        for name, stats in spans.items():
            lines.append(
                f"| {name} | {int(stats['count'])} | {stats['total_ms']:.1f} "
                f"| {stats['max_ms']:.1f} | {100.0 * stats['frac_of_wall']:.1f}% |"
            )
    events = report.get("events") or {}
    instants = events.get("instants") or {}
    counters = events.get("counters") or {}
    if instants or counters or events.get("tracker_errors"):
        lines += ["", "## Events", ""]
        for name, count in sorted(instants.items()):
            lines.append(f"- {name}: {count}")
        for name, count in sorted(counters.items()):
            lines.append(f"- {name}: {_fmt(count)}")
        if events.get("tracker_errors"):
            lines.append(f"- tracker errors (degraded to warnings): {events['tracker_errors']}")
        if events.get("timeline_events_dropped"):
            lines.append(f"- timeline events dropped (cap): {events['timeline_events_dropped']}")
    goodput = report.get("goodput") or {}
    if goodput:
        from .goodput import render_goodput_md

        lines += ["", "## Goodput", ""]
        if events.get("timeline_events_dropped"):
            lines.append(
                "- **warning**: the timeline dropped "
                f"{events['timeline_events_dropped']} event(s) (retention "
                "cap) — attribution below may undercount span categories"
            )
            lines.append("")
        lines.append(render_goodput_md(goodput).rstrip("\n"))
    serving = report.get("serving") or {}
    if serving:
        lines += ["", "## Serving", ""]
        req = serving.get("requests") or {}
        lines.append(
            f"- requests: {_fmt(req.get('completed'))}/{_fmt(req.get('submitted'))}"
            f" completed, {_fmt(req.get('failed'))} failed, "
            f"{_fmt(req.get('timed_out'))} timed out"
        )
        slo = serving.get("slo") or {}
        for key, label in (("ttft_ms", "TTFT"), ("per_token_ms", "per-token")):
            pct = slo.get(key) or {}
            lines.append(
                f"- {label} p50/p95/p99: {_fmt(pct.get('p50'))} / "
                f"{_fmt(pct.get('p95'))} / {_fmt(pct.get('p99'))} ms"
            )
        tpt = serving.get("throughput") or {}
        lines.append(
            f"- tokens/sec: {_fmt(tpt.get('tokens_per_sec'))} "
            f"({_fmt(tpt.get('new_tokens'))} new tokens in "
            f"{_fmt(tpt.get('wall_sec'))} s)"
        )
        occ = serving.get("occupancy") or {}
        lines.append(
            f"- batch occupancy: peak {_fmt(occ.get('peak'))}, mean "
            f"{_fmt(occ.get('mean'))} of {_fmt(occ.get('max_batch_slots'))} slots"
        )
        kv = serving.get("kv_pool") or {}
        if kv:
            lines.append(
                f"- KV pool: peak {_fmt(kv.get('peak_allocated_blocks'))} of "
                f"{_fmt(kv.get('capacity_blocks'))} blocks "
                f"({_fmt(kv.get('block_tokens'))} tokens each)"
            )
        comp = serving.get("compile") or {}
        if comp:
            lines.append(
                f"- compiled programs: {_fmt(comp.get('prefill_programs'))} "
                f"prefill + {_fmt(comp.get('decode_programs'))} decode "
                f"(budget {_fmt(comp.get('budget'))}, within: "
                f"{comp.get('within_budget')})"
            )
        par = serving.get("parity") or {}
        if par:
            lines.append(
                f"- parity vs sequential generate(): "
                f"{_fmt(par.get('checked', 0) - par.get('mismatched', 0))}/"
                f"{_fmt(par.get('checked'))} bitwise-identical"
            )
    perf = report.get("perf_attribution") or {}
    if perf:
        lines += ["", "## Performance attribution", ""]
        peaks = perf.get("peaks") or {}
        lines.append(
            f"- device: {perf.get('device_kind', '?')} × {perf.get('n_chips', 1)} "
            f"(peak {_fmt(peaks.get('peak_flops'))} FLOP/s, "
            f"HBM {_fmt_bytes(peaks.get('hbm_bytes_per_sec'))}/s, "
            f"ICI {_fmt_bytes(peaks.get('ici_bytes_per_sec'))}/s)"
        )
        mfu_block = perf.get("mfu") or {}
        if mfu_block:
            line = (
                f"- MFU: analytical {_fmt(mfu_block.get('analytical'))} vs "
                f"measured {_fmt(mfu_block.get('measured'))}"
            )
            if "ratio_analytical_over_measured" in mfu_block:
                line += (
                    f" (flop-model ratio {_fmt(mfu_block['ratio_analytical_over_measured'])}"
                    f", reconciled: {mfu_block.get('reconciled')})"
                )
            lines.append(line)
        split = perf.get("step_time_split_ms") or {}
        if split:
            lines.append(
                f"- step time {_fmt(split.get('step'))} ms = compute "
                f"{_fmt(split.get('analytical_compute'))} + collective "
                f"{_fmt(split.get('analytical_collective'))} + host "
                f"{_fmt(split.get('measured_host'))} + unattributed "
                f"{_fmt(split.get('unattributed_gap'))}"
            )
        for exe in perf.get("executables") or []:
            roof = exe.get("roofline") or {}
            lines.append(
                f"- `{exe.get('name', '?')}`: {_fmt(exe.get('flops'))} flops, "
                f"{_fmt_bytes(exe.get('bytes_accessed'))} accessed, "
                f"intensity {_fmt(roof.get('arithmetic_intensity'))} "
                f"(ridge {_fmt(roof.get('ridge_intensity'))}) → "
                f"**{roof.get('class', '?')}-bound**"
            )
            rows = exe.get("top_ops") or []
            if rows:
                from .profiling import render_top_ops_markdown

                lines += [""] + render_top_ops_markdown(rows) + [""]
    result = report.get("train_result")
    if result:
        lines += ["", "## Result", ""]
        for key in (
            "final_step",
            "final_loss",
            "final_val_loss",
            "total_tokens",
            "parameter_count",
            "preempted",
            "rollbacks",
        ):
            if key in result:
                lines.append(f"- {key}: {_fmt(result[key])}")
    return "\n".join(lines) + "\n"


def write_reports(run_dir: str | Path, report: dict[str, Any]) -> tuple[Path | None, Path | None]:
    """Write ``report.json`` and ``report.md`` into the run dir. Never
    raises — the report describes the run, it must not fail it."""
    base = Path(run_dir)
    json_path = base / "report.json"
    md_path = base / "report.md"
    try:
        base.mkdir(parents=True, exist_ok=True)
        json_path.write_text(
            json.dumps(report, indent=2, sort_keys=False), encoding="utf-8"
        )
    except (OSError, TypeError, ValueError) as exc:
        logger.warning("report.json write failed (%s)", exc)
        json_path = None
    try:
        md_path.write_text(render_markdown(report), encoding="utf-8")
    except OSError as exc:
        logger.warning("report.md write failed (%s)", exc)
        md_path = None
    return json_path, md_path


__all__ = ["build_report", "render_markdown", "write_reports"]
