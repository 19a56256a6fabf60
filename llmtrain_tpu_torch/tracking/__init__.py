"""Experiment tracking (the port's copy of ``llmtrain_tpu/tracking/``):
the Tracker protocol and the MLflow, SQLite, TensorBoard and null backends.

Pure Python, like the JAX package's: the same backends write the same
rows and records, so either package's reader reads the other's store.
"""

from __future__ import annotations

from typing import Any

from .base import NullTracker, Tracker
from .mlflow import MLflowTracker
from .sqlite import SqliteTracker
from .tensorboard import TensorBoardTracker


def _mlflow_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("mlflow") is not None


def _reject_native_owned_db(tracking_uri: str) -> None:
    """The reverse of SqliteTracker's foreign-schema sniff.

    An image that GAINS the mlflow extra flips ``backend: auto`` from the
    native store to MLflow at the same tracking URI (the k8s configmap
    shares ``sqlite:////mlflow/mlflow.db``). mlflow's SqlAlchemy store
    would then initialize against a file whose runs/params/metrics/tags
    tables have the native backend's columns — dying in an opaque
    alembic/OperationalError (and possibly writing migration state into
    the native file). Sniff the native marker columns up front and name
    the fix instead. Only sqlite: URIs can collide; server URIs pass.
    """
    if not tracking_uri.startswith("sqlite:"):
        return
    from .sqlite import resolve_db_path

    db_path = resolve_db_path(tracking_uri)
    if not db_path.exists():
        return
    import sqlite3

    try:
        with sqlite3.connect(db_path) as conn:
            cols = {row[1] for row in conn.execute("PRAGMA table_info(runs)")}
    except sqlite3.Error:
        return  # unreadable/odd file: let mlflow produce its own error
    if cols and {"run_id", "experiment"} <= cols:
        raise RuntimeError(
            f"tracking DB {str(db_path)!r} was created by the native SQLite "
            "backend; the mlflow backend cannot share it. Point "
            "mlflow.tracking_uri at a separate file, or set "
            "mlflow.backend: native to keep using this DB."
        )


def build_tracker(mlflow_cfg: Any, run_id: str) -> Tracker:
    """Backend selection for the main process (``mlflow.backend``):

    * ``mlflow`` — the MLflow client (raises a clear error at start_run
      when the extra is missing).
    * ``native`` — the stdlib SQLite store (tracking/sqlite.py).
    * ``tensorboard`` — native event-file writer
      (tracking/tensorboard.py); ``tracking_uri`` is the logdir root.
    * ``auto`` (default) — MLflow when importable, else the native store
      pointed at the same tracking URI, so tracking works out of the box
      on hosts without the extra. The
      two backends share the URI convention but NOT an on-disk schema —
      a given DB file belongs to whichever backend created it.
    """
    backend = getattr(mlflow_cfg, "backend", "auto")
    run_name = mlflow_cfg.run_name or run_id
    if backend == "tensorboard":
        return TensorBoardTracker(
            mlflow_cfg.tracking_uri, mlflow_cfg.experiment, run_name=run_name
        )
    if backend == "mlflow" or (backend == "auto" and _mlflow_available()):
        _reject_native_owned_db(mlflow_cfg.tracking_uri)
        return MLflowTracker(
            mlflow_cfg.tracking_uri, mlflow_cfg.experiment, run_name=run_name
        )
    if backend == "auto":
        from ..utils.logging import get_logger

        get_logger().info(
            "mlflow not installed; tracking with the native SQLite backend "
            "at %s (mlflow.backend: native silences this)",
            mlflow_cfg.tracking_uri,
        )
    return SqliteTracker(
        mlflow_cfg.tracking_uri, mlflow_cfg.experiment, run_name=run_name
    )


__all__ = [
    "MLflowTracker",
    "NullTracker",
    "SqliteTracker",
    "TensorBoardTracker",
    "Tracker",
    "build_tracker",
]
