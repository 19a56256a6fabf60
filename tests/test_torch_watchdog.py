"""The port's hang watchdog, heartbeat and straggler telemetry against the
JAX package's, on the CPU.

Units: ``StragglerTracker.observe`` gives JAX's dicts over the same
interval sequences; the progress beacon's heartbeat; the watchdog fires
with a recording exit function, writes JAX's ``hang_report_*`` file with
the thread stacks ahead of the port's device section, and a failing
``on_hang`` does not hold the exit; the checkpoint manager's bounded
drain abandons a wedged write (JAX's ``TestBoundedCheckpointDrain``).
Ends: ``train`` with a host hang and with a prefetcher hang exits 76 with
a hang report and a heartbeat in both CLIs, a clean watchdog-armed run
exits 0, and of two gloo ranks the one that hangs for a second is flagged
as a persistent straggler.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import yaml
from test_torch_ddp import free_port
from torch_port_helpers import port_env, run_cli

from llmtrain_tpu.resilience import watchdog as jax_watchdog
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.resilience import watchdog as port_watchdog
from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]


def _raw(tmp_path: Path, *, resilience: dict, **trainer) -> dict:
    return {
        "schema_version": 1,
        "run": {"name": "wd", "seed": 3, "device": "cpu", "deterministic": True},
        "model": {"name": "gpt", "block_size": 8, "d_model": 32, "n_layers": 1, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "vocab_size": 64, "extra": {"tokenizer": "byte"}},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 8, "micro_batch_size": 2, "warmup_steps": 0,
                    "log_every_steps": 2, "eval_every_steps": 8, "save_every_steps": 8,
                    **trainer},
        "resilience": resilience,
        "mlflow": {"enabled": False},
        "logging": {"level": "INFO", "json_output": False, "log_to_file": True},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


def _write(tmp_path: Path, raw: dict, name: str) -> Path:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


_INTERVALS = {
    "one-slow-host": [[0.10, 0.11, 0.35, 0.10]],
    "persistent": [[0.1, 0.5], [0.1, 0.5], [0.5, 0.1], [0.1, 0.1]],
    "single-host": [[0.2]],
    "zero-median": [[0.0, 0.0, 0.3], [0.0, 0.0, 0.3]],
    "ties": [[0.2, 0.2, 0.2], [0.4, 0.1, 0.1], [0.4, 0.1, 0.1], [0.4, 0.1, 0.1]],
}


@pytest.mark.parametrize("case", sorted(_INTERVALS))
@pytest.mark.parametrize("skew,patience", [(2.0, 3), (1.5, 1)])
def test_straggler_tracker_matches_jax(case: str, skew: float, patience: int) -> None:
    kw = dict(skew_factor=skew, patience=patience)
    jax_t, port_t = jax_watchdog.StragglerTracker(**kw), port_watchdog.StragglerTracker(**kw)
    for times in _INTERVALS[case]:
        arr = np.asarray(times)
        assert port_t.observe(arr) == jax_t.observe(arr)


def test_beacon_heartbeat_and_its_age(tmp_path) -> None:
    hb = tmp_path / "hb" / "heartbeat"
    beacon = port_watchdog.ProgressBeacon(hb, heartbeat_interval_sec=0.0)
    assert port_watchdog.heartbeat_age_seconds(hb) is None
    beacon.touch(7)
    step, age = beacon.snapshot()
    assert step == 7 and age < 5.0 and hb.is_file()
    assert port_watchdog.heartbeat_age_seconds(hb) < 5.0
    os.utime(hb, (time.time() - 100, time.time() - 100))
    assert port_watchdog.heartbeat_age_seconds(hb) >= 99.0
    port_watchdog.ProgressBeacon(None).touch(1)  # no file: no error


def test_stall_fires_report_and_exit(tmp_path) -> None:
    """A stalled beacon: the watchdog writes JAX's report file (the header,
    the thread stacks, then the device section) and calls the exit with
    76; a failing ``on_hang`` is logged and does not hold it."""
    exits: list[int] = []
    hooked = threading.Event()

    def on_hang():
        hooked.set()
        raise RuntimeError("drain failed")

    beacon = port_watchdog.ProgressBeacon(None)
    beacon.touch(5)
    dog = port_watchdog.HangWatchdog(beacon, stall_timeout_sec=0.2, poll_interval_sec=0.02,
                                     report_dir=tmp_path, process_index=3,
                                     exit_fn=exits.append, on_hang=on_hang)
    dog.arm()
    deadline = time.monotonic() + 10
    while not exits and time.monotonic() < deadline:
        time.sleep(0.02)
    dog.disarm()
    assert exits == [76] and dog.fired and hooked.is_set()
    (report,) = tmp_path.glob("hang_report_*_p3.txt")
    text = report.read_text()
    assert "last completed dispatch: step 5" in text
    sections = [text.index(s) for s in ("== thread stacks ==", "--- thread MainThread",
                                        "== device diagnostics ==", "torch ", "nvidia-smi")]
    assert sections == sorted(sections)
    live = port_watchdog.HangWatchdog(port_watchdog.ProgressBeacon(None), stall_timeout_sec=5,
                                      exit_fn=exits.append)
    live.arm()
    time.sleep(0.2)
    live.disarm()
    assert exits == [76] and not live.fired


def test_wait_pending_and_close_abandon_a_wedged_write(tmp_path, monkeypatch) -> None:
    """JAX's ``TestBoundedCheckpointDrain``: a write wedged on dead storage
    does not hold ``wait_pending`` or ``close`` when the caller bounds
    them; an unbounded close still drains a healthy write."""
    mgr = CheckpointManager(tmp_path / "ck")
    release = threading.Event()
    monkeypatch.setattr(mgr, "save_host", lambda *a, **k: release.wait(), raising=False)
    errors = []
    from llmtrain_tpu_torch.utils.logging import get_logger

    class Grab(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())

    handler = Grab()
    get_logger().addHandler(handler)
    try:
        mgr.save_host_async(1, {}, {})
        start = time.monotonic()
        assert mgr.wait_pending(timeout=0.2) is False
        mgr.close(timeout=0.2)
        assert time.monotonic() - start < 5.0
        assert any("abandoning" in m for m in errors)
    finally:
        release.set()
        get_logger().removeHandler(handler)
    healthy = CheckpointManager(tmp_path / "ok")
    healthy.save_host_async(1, {"params": {"w": np.zeros(2, np.float32)}, "opt_state": {}},
                            {"a": 1})
    healthy.close()
    assert (tmp_path / "ok" / "step_000001.ckpt").is_file()


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("site", ["host", "prefetcher"])
def test_injected_hang_exits_76_with_report_and_heartbeat(tmp_path, package, site) -> None:
    raw = _raw(tmp_path, resilience={
        "watchdog": {"enabled": True, "stall_timeout_sec": 0.8},
        "faults": {"hang_at_step": 3, "hang_in_prefetcher": site == "prefetcher"}})
    cfg = _write(tmp_path, raw, "hang.yaml")
    module = "llmtrain_tpu" if package == "jax" else "llmtrain_tpu_torch"
    env = port_env(JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, "train", "--config", str(cfg),
                           "--run-id", "hung"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 76, proc.stderr[-3000:]
    assert "HANG DETECTED" in proc.stderr
    run_dir = tmp_path / "runs" / "hung"
    (report,) = run_dir.glob("hang_report_*_p0.txt")
    text = report.read_text()
    assert "== thread stacks ==" in text and "last completed dispatch: step" in text
    if site == "prefetcher":
        assert "batch-prefetch" in text
    if package == "port":
        assert "== device diagnostics ==" in text and "torch " in text
    assert (run_dir / "heartbeat").is_file()


def test_clean_watchdog_armed_run_exits_0(tmp_path, capsys) -> None:
    raw = _raw(tmp_path, resilience={"watchdog": {"enabled": True, "stall_timeout_sec": 60}})
    cfg = _write(tmp_path, raw, "clean.yaml")
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "clean",
                               "--json"]) == 0
    result = json.loads(capsys.readouterr().out)["train_result"]
    assert result["final_step"] == 8
    run_dir = tmp_path / "runs" / "clean"
    assert (run_dir / "heartbeat").is_file() and not list(run_dir.glob("hang_report_*"))


# Each rank loads its own config: RANK in an argument is the rank.
_RANKED_CHILD = """
import os, sys
from llmtrain_tpu_torch.cli import main
sys.exit(main([a.replace("RANK", os.environ["RANK"]) for a in sys.argv[1:]]))
"""


def test_hung_rank_is_flagged_as_a_straggler(tmp_path) -> None:
    """Two gloo ranks, rank 1 hung for 1.2 s at step 3 (``hang_at_step``
    with ``hang_duration_sec``): rank 1 is the slowest host of that
    interval by far more than the skew factor, so with
    ``straggler_patience: 1`` it is flagged persistent; the timeline holds
    the ``straggler_persistent`` instant and the skew gauge."""
    raw = yaml.safe_load((REPO / "configs/presets/ddp_smoke.yaml").read_text())
    raw["trainer"].update(max_steps=8, log_every_steps=2, eval_every_steps=8,
                          save_every_steps=8)
    raw["distributed"]["timeout_sec"] = 60
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["resilience"] = {"watchdog": {"straggler_patience": 1, "straggler_skew_factor": 2.0}}
    _write(tmp_path, raw, "rank0.yaml")
    raw["resilience"]["faults"] = {"hang_at_step": 3, "hang_duration_sec": 1.2}
    _write(tmp_path, raw, "rank1.yaml")
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKED_CHILD, "train", "--config",
         str(tmp_path / "rankRANK.yaml"), "--run-id", "s"],
        cwd=tmp_path, env=port_env(RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                                   MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs[0][2][-3000:]
    err0 = outs[0][2]
    assert "persistent straggler: host 1" in err0, err0[-3000:]
    events = [json.loads(line) for line in
              (tmp_path / "runs" / "s" / "telemetry" / "timeline.jsonl").read_text().splitlines()]
    flagged = [e for e in events if e.get("name") == "straggler_persistent"]
    assert flagged and flagged[0]["args"]["slowest_host"] == 1
    assert flagged[0]["args"]["skew"] >= 2.0
    prom = (tmp_path / "runs" / "s" / "telemetry" / "metrics.prom").read_text()
    assert "llmtrain_train_step_time_skew" in prom
