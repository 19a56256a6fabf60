"""MLflow tracker (the port's copy of ``llmtrain_tpu/tracking/mlflow.py``).

The ``mlflow`` package is imported lazily, at ``start_run``; without it the
tracker raises a clear ``RuntimeError`` naming the fix. Nested params are
flattened to dot keys, lists JSON-encoded (:func:`_flatten_params`, which
the other backends share, so a run recorded by any of them reads the same).

Join semantics: the join key is the ``llmtrain.run_id`` tag. ``start_run``
searches the experiment for a run already tagged with the framework run id
and reattaches to it, so an ``--auto-resume`` relaunch after preemption
CONTINUES the original MLflow run instead of opening a second one. Only
rank 0 gets a real tracker (non-main ranks get NullTracker, see cli.py),
so there is no concurrent writer.
"""

from __future__ import annotations

import json
from typing import Any


def _flatten_params(params: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for key, value in params.items():
        full = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten_params(value, full))
        elif isinstance(value, (list, tuple)):
            flat[full] = json.dumps(list(value))
        else:
            flat[full] = value
    return flat


class MLflowTracker:
    def __init__(
        self,
        tracking_uri: str,
        experiment: str,
        *,
        run_name: str | None = None,
    ) -> None:
        self._tracking_uri = tracking_uri
        self._experiment = experiment
        self._run_name = run_name
        self._mlflow = None
        self._active = False

    def _require_mlflow(self):
        if self._mlflow is None:
            try:
                import mlflow
            except ImportError as exc:
                raise RuntimeError(
                    "mlflow is not installed; install the [mlflow] extra or set "
                    "mlflow.enabled: false"
                ) from exc
            self._mlflow = mlflow
        return self._mlflow

    def start_run(self, run_id: str, run_name: str | None = None) -> None:
        mlflow = self._require_mlflow()
        mlflow.set_tracking_uri(self._tracking_uri)
        mlflow.set_experiment(self._experiment)
        existing = self._find_existing_run(run_id)
        if existing is not None:
            mlflow.start_run(run_id=existing)
        else:
            mlflow.start_run(run_name=run_name or self._run_name or run_id)
            mlflow.set_tag("llmtrain.run_id", run_id)
        self._active = True

    def _find_existing_run(self, run_id: str) -> str | None:
        """MLflow run id of an existing run tagged with this framework run id.

        The join key for crash-restart continuity: a relaunch with the same
        stable run id (``--auto-resume``) reattaches instead of starting a
        second MLflow run. Best-effort — any search failure means a fresh
        run, never a crashed launch.
        """
        mlflow = self._require_mlflow()
        if "'" in run_id or '"' in run_id:
            # Quotes can't be escaped portably in MLflow filter strings;
            # generated ids never contain them (run_id.py slugs), only a
            # hand-picked --run-id can. Skip the join rather than crash.
            from ..utils.logging import get_logger

            get_logger().warning(
                "run id %r contains quotes; skipping MLflow run-join search",
                run_id,
            )
            return None
        try:
            experiment = mlflow.get_experiment_by_name(self._experiment)
            if experiment is None:
                return None
            runs = mlflow.search_runs(
                experiment_ids=[experiment.experiment_id],
                filter_string=f"tags.\"llmtrain.run_id\" = '{run_id}'",
                max_results=1,
                output_format="list",
            )
        except Exception as exc:  # noqa: BLE001
            from ..utils.logging import get_logger

            get_logger().warning(
                "could not search for an existing MLflow run (%s); starting fresh",
                exc,
            )
            return None
        return runs[0].info.run_id if runs else None

    def log_params(self, params: dict[str, Any]) -> None:
        if self._active:
            self._require_mlflow().log_params(_flatten_params(params))

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        if self._active:
            self._require_mlflow().log_metrics(metrics, step=step)

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        if self._active:
            self._require_mlflow().log_artifact(local_path, artifact_path=artifact_path)

    def end_run(self, status: str = "FINISHED") -> None:
        if self._active:
            self._require_mlflow().end_run(status=status)
            self._active = False
