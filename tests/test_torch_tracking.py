"""The port's trackers (llmtrain_tpu_torch/tracking/) against the JAX
package's, on the CPU.

The same call sequence goes through both packages' SQLite stores (rows
compared table by table, up to the random run uuid and the wall-clock
stamps; each package's reader reads the other's file) and both packages'
TensorBoard writers (the event files compared byte for byte, with the wall
clock pinned). ``MLflowTracker`` runs against ``tests/fake_mlflow.py``, as
the JAX package's own parity test runs it, and ``build_tracker`` makes the
same choice as JAX's for every backend.
"""

from __future__ import annotations

import math
import sqlite3
import sys
from types import SimpleNamespace

import fake_mlflow
import pytest
import torch_port_helpers  # noqa: F401

import llmtrain_tpu.tracking as jax_tracking
import llmtrain_tpu_torch.tracking as port_tracking
from llmtrain_tpu.tracking import sqlite as jax_sqlite
from llmtrain_tpu.tracking import tensorboard as jax_tb
from llmtrain_tpu_torch.tracking import mlflow as port_mlflow
from llmtrain_tpu_torch.tracking import sqlite as port_sqlite
from llmtrain_tpu_torch.tracking import tensorboard as port_tb

PARAMS = {
    "model": {"d_model": 64, "dropout": 0.1, "mesh": [2, 4]},
    "trainer": {"lr": 3e-4, "extra": {"note": "a|b\nc"}},
    "run_name": "parity",
}


@pytest.fixture()
def mlflow_fake(monkeypatch):
    fake_mlflow.reset()
    monkeypatch.setitem(sys.modules, "mlflow", fake_mlflow)
    yield fake_mlflow
    fake_mlflow.reset()


def _drive(tracker, run_id: str, artifact: str) -> None:
    """The calls ``train`` and the trainer make over a run, then an
    ``--auto-resume`` relaunch that must join the same run."""
    tracker.start_run(run_id)
    tracker.log_params(PARAMS)
    tracker.log_metrics({"train/loss": 2.5, "train/lr": 3e-4}, step=1)
    tracker.log_metrics({"train/loss": 2.25}, step=2)
    tracker.log_metrics({"val/loss": float("nan")}, step=2)
    tracker.log_artifact(artifact, artifact_path="configs")
    tracker.end_run("FINISHED")
    tracker.start_run(run_id)
    tracker.log_metrics({"train/loss": 2.0}, step=3)
    tracker.end_run("FAILED")


def _rows(db) -> dict[str, list[tuple]]:
    """Every table's rows without the run uuid and the wall-clock columns."""
    drop = {"run_uuid", "start_time", "end_time", "timestamp"}
    out = {}
    with sqlite3.connect(db) as conn:
        for table in ("runs", "params", "metrics", "tags", "artifacts"):
            cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")]
            keep = [c for c in cols if c not in drop]
            out[table] = sorted(
                tuple("nan" if isinstance(v, float) and math.isnan(v) else v for v in row)
                for row in conn.execute(f"SELECT {', '.join(keep)} FROM {table}")
            )
        out["schema"] = sorted(
            r[0] for r in conn.execute("SELECT sql FROM sqlite_master WHERE sql IS NOT NULL")
        )
    return out


def test_sqlite_stores_write_the_same_rows(tmp_path) -> None:
    art = tmp_path / "config.yaml"
    art.write_text("x: 1\n")
    dbs = {}
    for name, module in (("jax", jax_sqlite), ("port", port_sqlite)):
        dbs[name] = tmp_path / f"{name}.db"
        _drive(module.SqliteTracker(f"sqlite:///{dbs[name]}", "exp", run_name="parity"),
               "run-p", str(art))
    jax_rows, port_rows = _rows(dbs["jax"]), _rows(dbs["port"])
    assert port_rows == jax_rows
    assert len(port_rows["runs"]) == 1 and port_rows["runs"][0][-1] == "FAILED"
    assert len(port_rows["metrics"]) == 5


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_other_s_sqlite_file(tmp_path, writer, reader) -> None:
    art = tmp_path / "config.yaml"
    art.write_text("x: 1\n")
    db = tmp_path / "store.db"
    mods = {"jax": jax_sqlite, "port": port_sqlite}
    _drive(mods[writer].SqliteTracker(f"sqlite:///{db}", "exp"), "run-x", str(art))
    read, own = mods[reader], mods[writer]
    assert read.read_params(db, "run-x", "exp") == own.read_params(db, "run-x", "exp")
    theirs = [(m["key"], m["step"]) for m in read.read_metrics(db, "run-x")]
    ours = [(m["key"], m["step"]) for m in own.read_metrics(db, "run-x")]
    assert theirs == ours and len(theirs) == 5
    assert math.isnan(read.read_metrics(db, "run-x", key="val/loss")[0]["value"])
    assert [r["status"] for r in read.read_runs(db, "exp")] == ["FAILED"]
    # A run the reader's package appends to the same file joins the store.
    read.SqliteTracker(f"sqlite:///{db}", "exp").start_run("run-y")
    assert {r["run_id"] for r in own.read_runs(db)} == {"run-x", "run-y"}


def test_resolve_db_path_matches_jax() -> None:
    for uri in ("sqlite:///rel/x.db", "sqlite:////abs/x.db", "file:/tmp/m", "plain/dir"):
        assert port_sqlite.resolve_db_path(uri) == jax_sqlite.resolve_db_path(uri), uri
    for uri in ("file:///tmp/tb", "file:/tmp/tb", "tb"):
        assert port_tb.resolve_logdir(uri) == jax_tb.resolve_logdir(uri), uri


def test_tensorboard_event_files_are_byte_identical(tmp_path, monkeypatch) -> None:
    """With the wall clock pinned, the two writers' files (name and bytes)
    are the same."""
    frozen = SimpleNamespace(time=lambda: 1_700_000_000.25)
    art = tmp_path / "config.yaml"
    art.write_text("x: 1\n")
    files = {}
    for name, module in (("jax", jax_tb), ("port", port_tb)):
        monkeypatch.setattr(module, "time", frozen)
        root = tmp_path / name
        tracker = module.TensorBoardTracker(str(root), "exp", run_name="parity")
        tracker.start_run("run-t")
        tracker.log_params(PARAMS)
        tracker.log_metrics({"train/loss": 2.5, "train/lr": 3e-4}, step=1)
        tracker.log_metrics({}, step=2)
        tracker.log_metrics({"val/loss": float("nan")}, step=2)
        tracker.log_artifact(str(art), artifact_path="configs")
        tracker.log_artifact(str(art))
        tracker.end_run()
        (path,) = (root / "exp" / "parity").iterdir()
        files[name] = path
    assert files["port"].name == files["jax"].name
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    assert port_tb._masked_crc(b"llmtrain") == jax_tb._masked_crc(b"llmtrain")


def test_tensorboard_refuses_a_second_start(tmp_path) -> None:
    tracker = port_tb.TensorBoardTracker(str(tmp_path), "exp")
    tracker.start_run("r")
    with pytest.raises(RuntimeError, match="start_run called twice"):
        tracker.start_run("r")
    tracker.end_run()
    with pytest.raises(RuntimeError, match="not started"):
        tracker.log_metrics({"a": 1.0}, step=1)


def test_mlflow_tracker_matches_jax_on_the_fake_store(mlflow_fake, tmp_path) -> None:
    """Both packages' MLflowTracker against fake_mlflow: the relaunch joins
    the run, and params, metrics, tags, artifacts and status agree; the
    native store reads back the same params and metric history."""
    from llmtrain_tpu.tracking.mlflow import MLflowTracker as JaxMLflow

    art = tmp_path / "config.yaml"
    art.write_text("x: 1\n")
    runs = {}
    for name, cls in (("jax", JaxMLflow), ("port", port_mlflow.MLflowTracker)):
        uri = f"sqlite:///{name}.db"
        _drive(cls(uri, "exp", run_name="parity"), "run-m", str(art))
        (run,) = mlflow_fake._stores[uri].runs.values()
        runs[name] = run
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run.status == jax_run.status == "FAILED"
    assert port_run.params == jax_run.params
    assert port_run.tags == jax_run.tags and port_run.tags["llmtrain.run_id"] == "run-m"
    assert [(m["key"], m["step"]) for m in port_run.metrics] == \
        [(m["key"], m["step"]) for m in jax_run.metrics]
    assert port_run.artifacts == jax_run.artifacts == [(str(art), "configs")]
    db = tmp_path / "native.db"
    _drive(port_sqlite.SqliteTracker(f"sqlite:///{db}", "exp"), "run-m", str(art))
    assert port_sqlite.read_params(db, "run-m") == port_run.params
    assert port_mlflow._flatten_params(PARAMS) == \
        __import__("llmtrain_tpu.tracking.mlflow", fromlist=["x"])._flatten_params(PARAMS)


def test_mlflow_tracker_without_mlflow_raises_the_clear_error(monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "mlflow", None)
    tracker = port_mlflow.MLflowTracker("sqlite:///x.db", "exp")
    with pytest.raises(RuntimeError, match=r"mlflow is not installed"):
        tracker.start_run("r")


def test_mlflow_search_failure_and_quoted_ids_start_fresh(mlflow_fake, monkeypatch) -> None:
    tracker = port_mlflow.MLflowTracker("sqlite:///q.db", "exp")
    for _ in range(2):
        tracker.start_run("it's-a-run")
        tracker.end_run()
    assert len(mlflow_fake._stores["sqlite:///q.db"].runs) == 2

    def boom(**kwargs):
        raise Exception("backend down")

    monkeypatch.setattr(mlflow_fake, "search_runs", boom)
    tracker = port_mlflow.MLflowTracker("sqlite:///f.db", "exp")
    for _ in range(2):
        tracker.start_run("r1")
        tracker.end_run()
    assert len(mlflow_fake._stores["sqlite:///f.db"].runs) == 2


@pytest.mark.parametrize(
    "backend,mlflow_importable",
    [("auto", False), ("auto", True), ("native", True), ("mlflow", False),
     ("tensorboard", True)],
    ids=["auto-without-mlflow", "auto-with-mlflow", "native", "mlflow", "tensorboard"],
)
def test_build_tracker_chooses_as_jax(tmp_path, monkeypatch, backend, mlflow_importable) -> None:
    cfg = SimpleNamespace(tracking_uri=f"sqlite:///{tmp_path}/t.db", experiment="exp",
                          run_name=None, backend=backend)
    chosen = []
    for module in (jax_tracking, port_tracking):
        monkeypatch.setattr(module, "_mlflow_available", lambda: mlflow_importable)
        chosen.append(type(module.build_tracker(cfg, "run-1")).__name__)
    assert chosen[1] == chosen[0], chosen
    assert chosen[1] == {"auto": "MLflowTracker" if mlflow_importable else "SqliteTracker",
                         "native": "SqliteTracker", "mlflow": "MLflowTracker",
                         "tensorboard": "TensorBoardTracker"}[backend]


def test_build_tracker_refuses_a_native_db_for_mlflow(tmp_path, monkeypatch) -> None:
    """Both packages' reverse sniff: a DB the native store created is not
    handed to MLflow, and the native store refuses MLflow's own schema."""
    db = tmp_path / "native.db"
    tracker = port_sqlite.SqliteTracker(f"sqlite:///{db}", "exp")
    tracker.start_run("r1")
    tracker.end_run()
    cfg = SimpleNamespace(tracking_uri=f"sqlite:///{db}", experiment="exp", run_name=None,
                          backend="auto")
    for module in (jax_tracking, port_tracking):
        monkeypatch.setattr(module, "_mlflow_available", lambda: True)
        with pytest.raises(RuntimeError, match="native SQLite backend"):
            module.build_tracker(cfg, "r2")
    foreign = tmp_path / "mlflow.db"
    with sqlite3.connect(foreign) as conn:
        conn.execute("CREATE TABLE runs (run_uuid TEXT, experiment_id INTEGER)")
    for module in (jax_sqlite, port_sqlite):
        with pytest.raises(RuntimeError, match="different product"):
            module.SqliteTracker(f"sqlite:///{foreign}", "exp").start_run("r")


def test_null_tracker_and_protocol() -> None:
    null = port_tracking.NullTracker()
    null.start_run("r")
    null.log_params({"a": 1})
    null.log_metrics({"a": 1.0}, step=1)
    null.log_artifact("x")
    null.end_run()
    assert isinstance(null, port_tracking.Tracker)
    assert set(port_tracking.__all__) == set(jax_tracking.__all__)
