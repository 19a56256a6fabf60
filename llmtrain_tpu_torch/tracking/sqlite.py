"""Native SQLite tracking backend — a real store with zero dependencies
(the port's copy of ``llmtrain_tpu/tracking/sqlite.py``).

mlflow is an optional heavyweight extra; on hosts without it this backend
persists the same information (runs, params, metrics with steps, tags,
artifacts) to a plain SQLite file with the stdlib ``sqlite3`` module.
``mlflow.backend: auto`` picks mlflow when importable and this store
otherwise; ``native`` forces it. The schema and the rows are the JAX
package's, so either package's reader reads the other's file.

Semantics mirror the MLflow tracker (tracking/mlflow.py):

* ``start_run`` joins an existing run carrying the same framework run id
  (``--auto-resume`` relaunches CONTINUE the run instead of opening a
  second one), else inserts a fresh row.
* Only rank 0 ever holds a real tracker (cli.py), so there is a single
  writer; WAL mode keeps concurrent readers safe.
* Params are flattened to dot keys exactly like the MLflow tracker.

The module-level ``read_runs``/``read_params``/``read_metrics`` helpers
are the query surface.
"""

from __future__ import annotations

import sqlite3
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any

from .mlflow import _flatten_params

_SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
    run_uuid     TEXT PRIMARY KEY,
    run_id       TEXT NOT NULL,
    experiment   TEXT NOT NULL,
    run_name     TEXT,
    status       TEXT NOT NULL,
    start_time   REAL NOT NULL,
    end_time     REAL,
    UNIQUE (run_id, experiment)
);
CREATE TABLE IF NOT EXISTS params (
    run_uuid TEXT NOT NULL REFERENCES runs(run_uuid),
    key      TEXT NOT NULL,
    value    TEXT NOT NULL,
    PRIMARY KEY (run_uuid, key)
);
CREATE TABLE IF NOT EXISTS metrics (
    run_uuid  TEXT NOT NULL REFERENCES runs(run_uuid),
    key       TEXT NOT NULL,
    -- Nullable: Python's sqlite3 binds float('nan') as NULL, and a
    -- diverged run logging loss=nan must not crash training. Reads map
    -- NULL back to nan (read_metrics).
    value     REAL,
    step      INTEGER,
    timestamp REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_metrics_run_key ON metrics (run_uuid, key, step);
CREATE TABLE IF NOT EXISTS tags (
    run_uuid TEXT NOT NULL REFERENCES runs(run_uuid),
    key      TEXT NOT NULL,
    value    TEXT NOT NULL,
    PRIMARY KEY (run_uuid, key)
);
CREATE TABLE IF NOT EXISTS artifacts (
    run_uuid      TEXT NOT NULL REFERENCES runs(run_uuid),
    local_path    TEXT NOT NULL,
    artifact_path TEXT
);
"""


def resolve_db_path(tracking_uri: str) -> Path:
    """Map a tracking URI to the SQLite file this backend uses.

    ``sqlite:///relative.db`` / ``sqlite:////abs/path.db`` follow
    MLflow's SQLite URI convention (three slashes relative, four
    absolute — so the k8s configmap value resolves identically under
    either backend); ``file:<dir>`` and plain paths get ``llmtrain.db``
    inside the directory.
    """
    if tracking_uri.startswith("sqlite:"):
        p = tracking_uri[len("sqlite:") :].lstrip("/")
        return Path("/" + p) if tracking_uri.startswith("sqlite:////") else Path(p)
    if tracking_uri.startswith("file:"):
        return Path(tracking_uri[len("file:") :]) / "llmtrain.db"
    return Path(tracking_uri) / "llmtrain.db"


class SqliteTracker:
    """Tracker protocol implementation over a local SQLite file."""

    def __init__(
        self,
        tracking_uri: str,
        experiment: str,
        *,
        run_name: str | None = None,
    ) -> None:
        self._db_path = resolve_db_path(tracking_uri)
        self._experiment = experiment
        self._run_name = run_name
        self._conn: sqlite3.Connection | None = None
        self._run_uuid: str | None = None

    # ------------------------------------------------------------- plumbing
    def _connect(self) -> sqlite3.Connection:
        if self._conn is None:
            self._db_path.parent.mkdir(parents=True, exist_ok=True)
            conn = sqlite3.connect(str(self._db_path))
            # Sniff BEFORE the WAL pragma: journal_mode=WAL is a persistent
            # on-disk change (+ -wal/-shm sidecars), and a foreign file must
            # be rejected untouched.
            self._reject_foreign_schema(conn)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.executescript(_SCHEMA)
            self._migrate_nullable_metric_values(conn)
            conn.commit()
            self._conn = conn
        return self._conn

    @staticmethod
    def _reject_foreign_schema(conn: sqlite3.Connection) -> None:
        """Refuse a DB whose ``runs`` table belongs to another product.

        MLflow's own SQLite store also has runs/params/metrics/tags
        tables (with ``experiment_id`` instead of this backend's
        ``run_id``/``experiment`` columns). With ``mlflow.backend: auto``
        and a shared tracking file (the k8s configmap's
        ``sqlite:////mlflow/mlflow.db``), an image that gains or loses
        the mlflow extra would silently point this backend at an
        mlflow-owned file: ``CREATE TABLE IF NOT EXISTS`` accepts the
        foreign tables and the first INSERT dies mid-training with an
        opaque OperationalError. Sniff up front and fail with a message
        that names the fix instead.
        """
        cols = {row[1] for row in conn.execute("PRAGMA table_info(runs)")}
        if cols and not {"run_id", "experiment"} <= cols:
            path = conn.execute("PRAGMA database_list").fetchone()[2]
            conn.close()
            raise RuntimeError(
                f"tracking DB {path!r} has a 'runs' table from a different "
                "product (likely MLflow's own SQLite store; its columns are "
                f"{sorted(cols)}). The native backend cannot share a file "
                "with the mlflow backend — point mlflow.tracking_uri at a "
                "separate file, or set mlflow.backend explicitly so both "
                "relaunches resolve to the backend that created this DB."
            )

    @staticmethod
    def _migrate_nullable_metric_values(conn: sqlite3.Connection) -> None:
        """v1 DBs declared metrics.value NOT NULL; CREATE IF NOT EXISTS
        can't relax that, and a NaN metric (bound as NULL) would still
        crash a resumed run against such a file. Rebuild the table once."""
        notnull = {
            row[1]: bool(row[3]) for row in conn.execute("PRAGMA table_info(metrics)")
        }
        if not notnull.get("value"):
            return
        conn.executescript(
            "DROP INDEX IF EXISTS idx_metrics_run_key;"
            "ALTER TABLE metrics RENAME TO _metrics_v1;"
        )
        conn.executescript(_SCHEMA)  # recreates metrics (nullable) + index
        conn.execute(
            "INSERT INTO metrics (run_uuid, key, value, step, timestamp) "
            "SELECT run_uuid, key, value, step, timestamp FROM _metrics_v1"
        )
        conn.execute("DROP TABLE _metrics_v1")

    # ------------------------------------------------------------- protocol
    def start_run(self, run_id: str, run_name: str | None = None) -> None:
        conn = self._connect()
        row = conn.execute(
            "SELECT run_uuid FROM runs WHERE run_id = ? AND experiment = ?",
            (run_id, self._experiment),
        ).fetchone()
        if row is not None:
            # Crash-restart continuity: an --auto-resume relaunch with the
            # same stable run id reattaches (mlflow.py join semantics).
            self._run_uuid = row[0]
            conn.execute(
                "UPDATE runs SET status = 'RUNNING', end_time = NULL "
                "WHERE run_uuid = ?",
                (self._run_uuid,),
            )
        else:
            import uuid

            self._run_uuid = uuid.uuid4().hex
            conn.execute(
                "INSERT INTO runs (run_uuid, run_id, experiment, run_name, "
                "status, start_time) VALUES (?, ?, ?, ?, 'RUNNING', ?)",
                (
                    self._run_uuid,
                    run_id,
                    self._experiment,
                    run_name or self._run_name or run_id,
                    time.time(),
                ),
            )
            conn.execute(
                "INSERT OR REPLACE INTO tags (run_uuid, key, value) "
                "VALUES (?, 'llmtrain.run_id', ?)",
                (self._run_uuid, run_id),
            )
        conn.commit()

    def log_params(self, params: dict[str, Any]) -> None:
        if self._run_uuid is None:
            return
        conn = self._connect()
        conn.executemany(
            "INSERT OR REPLACE INTO params (run_uuid, key, value) VALUES (?, ?, ?)",
            [
                (self._run_uuid, k, str(v))
                for k, v in _flatten_params(params).items()
            ],
        )
        conn.commit()

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        if self._run_uuid is None:
            return
        conn = self._connect()
        now = time.time()
        # NaN binds as NULL (nullable column; read_metrics maps it back) —
        # a diverged run logging loss=nan must log, not crash training.
        conn.executemany(
            "INSERT INTO metrics (run_uuid, key, value, step, timestamp) "
            "VALUES (?, ?, ?, ?, ?)",
            [(self._run_uuid, k, float(v), step, now) for k, v in metrics.items()],
        )
        conn.commit()

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        if self._run_uuid is None:
            return
        conn = self._connect()
        conn.execute(
            "INSERT INTO artifacts (run_uuid, local_path, artifact_path) "
            "VALUES (?, ?, ?)",
            (self._run_uuid, local_path, artifact_path),
        )
        conn.commit()

    def end_run(self, status: str = "FINISHED") -> None:
        if self._run_uuid is None:
            return
        conn = self._connect()
        conn.execute(
            "UPDATE runs SET status = ?, end_time = ? WHERE run_uuid = ?",
            (status, time.time(), self._run_uuid),
        )
        conn.commit()
        conn.close()
        self._conn = None
        self._run_uuid = None


# ------------------------------------------------------------------ queries
@contextmanager
def _reader(db_path: str | Path):
    # sqlite3's own context manager only commits/rolls back — it never
    # closes, which would leak a connection (and its WAL read lock) per
    # query in a polling dashboard.
    conn = sqlite3.connect(str(db_path))
    conn.row_factory = sqlite3.Row
    try:
        yield conn
    finally:
        conn.close()


def read_runs(db_path: str | Path, experiment: str | None = None) -> list[dict]:
    """All runs (optionally one experiment's), newest first."""
    with _reader(db_path) as conn:
        sql = "SELECT * FROM runs"
        args: tuple = ()
        if experiment is not None:
            sql += " WHERE experiment = ?"
            args = (experiment,)
        sql += " ORDER BY start_time DESC"
        return [dict(r) for r in conn.execute(sql, args)]


def read_params(
    db_path: str | Path, run_id: str, experiment: str | None = None
) -> dict[str, str]:
    """One run's params. Pass ``experiment`` when the DB may hold the
    same run id under several experiments (uniqueness is per pair) —
    without it, params from every matching run merge."""
    with _reader(db_path) as conn:
        sql = (
            "SELECT p.key, p.value FROM params p "
            "JOIN runs r ON r.run_uuid = p.run_uuid WHERE r.run_id = ?"
        )
        args: tuple = (run_id,)
        if experiment is not None:
            sql += " AND r.experiment = ?"
            args = (run_id, experiment)
        return {r["key"]: r["value"] for r in conn.execute(sql, args)}


def read_metrics(
    db_path: str | Path,
    run_id: str,
    key: str | None = None,
    experiment: str | None = None,
) -> list[dict]:
    """Metric rows (key, value, step, timestamp) in insertion order.

    NULL values read back as nan (NaN binds as NULL on insert). Pass
    ``experiment`` to disambiguate a run id shared across experiments.
    """
    with _reader(db_path) as conn:
        sql = (
            "SELECT m.key, m.value, m.step, m.timestamp FROM metrics m "
            "JOIN runs r ON r.run_uuid = m.run_uuid WHERE r.run_id = ?"
        )
        args: list = [run_id]
        if key is not None:
            sql += " AND m.key = ?"
            args.append(key)
        if experiment is not None:
            sql += " AND r.experiment = ?"
            args.append(experiment)
        sql += " ORDER BY m.rowid"
        rows = [dict(r) for r in conn.execute(sql, tuple(args))]
    for r in rows:
        if r["value"] is None:
            r["value"] = float("nan")
    return rows


__all__ = [
    "SqliteTracker",
    "resolve_db_path",
    "read_runs",
    "read_params",
    "read_metrics",
]
