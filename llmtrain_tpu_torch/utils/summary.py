"""Dual-format (JSON dict / indented text) run summaries (port of ``llmtrain_tpu/utils/summary.py``).

Parity target: reference ``src/llmtrain/utils/summary.py`` — echoes every
config section plus the distributed env snapshot (summary.py:13-15,34-91),
appends dry-run resolution or training results (summary.py:92-118), and
renders a ``Planned run:`` text block (summary.py:199-217).
"""

from __future__ import annotations

from typing import Any

from ..config.schemas import RunConfig
from .metadata import distributed_env_snapshot


def format_run_summary(
    cfg: RunConfig,
    *,
    run_id: str,
    run_dir: str | None,
    dry_run: bool = False,
    dry_run_result: Any | None = None,
    train_result: Any | None = None,
    as_json: bool = True,
) -> dict[str, Any] | str:
    """Build the run summary as a JSON-able dict or a human-readable string."""
    summary: dict[str, Any] = {
        "run_id": run_id,
        "run_dir": run_dir,
        "dry_run": dry_run,
        "run": cfg.run.model_dump(),
        "model": cfg.model.model_dump(),
        "data": cfg.data.model_dump(),
        "trainer": cfg.trainer.model_dump(),
        "distributed": cfg.distributed.model_dump(),
        "resilience": cfg.resilience.model_dump(),
        "telemetry": cfg.telemetry.model_dump(),
        "mlflow": cfg.mlflow.model_dump(),
        "logging": cfg.logging.model_dump(),
        "output": cfg.output.model_dump(),
        "distributed_env": distributed_env_snapshot(),
    }

    if dry_run_result is not None:
        summary["dry_run_resolution"] = {
            "model_adapter": dry_run_result.model_adapter,
            "data_module": dry_run_result.data_module,
            "steps_executed": dry_run_result.steps_executed,
        }

    if train_result is not None:
        summary["train_result"] = {
            "final_step": train_result.final_step,
            "final_loss": train_result.final_loss,
            "final_val_loss": train_result.final_val_loss,
            "first_step_loss": train_result.first_step_loss,
            "total_tokens": train_result.total_tokens,
            "total_time": train_result.total_time,
            "peak_memory": train_result.peak_memory,
            "parameter_count": train_result.parameter_count,
            "trainable_parameter_count": train_result.trainable_parameter_count,
            "val_metrics": dict(train_result.val_metrics or {}),
            "resumed_from_step": train_result.resumed_from_step,
            "preempted": getattr(train_result, "preempted", False),
            "rollbacks": getattr(train_result, "rollbacks", 0),
        }

    if as_json:
        return summary
    return _render_text(summary)


def _render_text(summary: dict[str, Any]) -> str:
    lines: list[str] = ["Planned run:" if summary["dry_run"] else "Run summary:"]
    lines.append(f"  run_id: {summary['run_id']}")
    lines.append(f"  run_dir: {summary['run_dir']}")
    for section in (
        "run",
        "model",
        "data",
        "trainer",
        "distributed",
        "resilience",
        "telemetry",
        "mlflow",
        "logging",
        "output",
    ):
        lines.append(f"  {section}:")
        _render_mapping(lines, summary[section], indent=2)
    env = summary.get("distributed_env") or {}
    if env:
        lines.append("  distributed_env:")
        _render_mapping(lines, env, indent=2)
    if "dry_run_resolution" in summary:
        lines.append("  dry_run_resolution:")
        _render_mapping(lines, summary["dry_run_resolution"], indent=2)
    if "train_result" in summary:
        lines.append("  train_result:")
        _render_mapping(lines, summary["train_result"], indent=2)
    return "\n".join(lines)


def _render_mapping(lines: list[str], mapping: dict[str, Any], indent: int) -> None:
    """Indented key/value rendering; nested dicts (e.g. ``distributed.mesh``)
    recurse instead of printing a one-line Python repr."""
    pad = "  " * indent
    for key, value in mapping.items():
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{key}:")
            _render_mapping(lines, value, indent + 1)
        else:
            lines.append(f"{pad}{key}: {value}")
