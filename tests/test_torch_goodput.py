"""The port's goodput ledger (llmtrain_tpu_torch/telemetry/goodput.py) and
``goodput`` command against the JAX package's, on the CPU.

* ``compute_goodput`` of both packages on the same hand-built run
  directories (one clean segment; a crash without a footer and a resume
  that replays steps; a torn tail line; a heartbeat that outlives the last
  event; suspension windows; clock jitter; no segment headers) gives the
  same ledger, markdown and gauges, and its categories sum to the wall.
* A run stopped by SIGTERM and continued by ``--auto-resume`` in the same
  run dir, in each package's CLI: two segments, the same categories, and
  no balance error; each package's ledger of either run dir is the same.
* ``goodput`` exits 0 with the ledger, 1 without a timeline and 2 for a
  missing run dir, in both CLIs, printing the same ledger.
"""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401
import yaml
from torch_port_helpers import run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.telemetry import goodput as jax_goodput
from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.telemetry import goodput as port_goodput
from llmtrain_tpu_torch.training.trainer import Trainer

T0 = 1_700_000_000.0


def _span(name: str, step: int | None, ts: float, dur: float, **extra) -> dict:
    event = {"name": name, "cat": extra.pop("cat", "train"), "ph": "X",
             "ts_us": int(ts * 1e6), "dur_us": int(dur * 1e6), "pid": 0, "tid": 1}
    if step is not None:
        event["step"] = step
    return {**event, **extra}


def _segment(seg_id: int, start: float, events: list[dict], end: float | None) -> list[dict]:
    lines = [{"name": "segment_start", "ph": "M", "segment_id": seg_id,
              "start_unix_time": start}]
    lines += events
    if end is not None:
        lines.append({"name": "segment_end", "ph": "M", "segment_id": seg_id,
                      "end_unix_time": end})
    return lines


def _steps(first: int, last: int, t: float) -> tuple[list[dict], float]:
    events = []
    for step in range(first, last + 1):
        events.append(_span("data_wait", step, t, 0.01, cat="data"))
        events.append(_span("host_dispatch", step, t + 0.01, 0.2))
        t += 0.25
        if step % 4 == 0:
            events.append(_span("interval_sync", step, t, 0.05))
            events.append(_span("checkpoint_save", step, t + 0.05, 0.1, cat="ckpt"))
            t += 0.2
    return events, t


def _write(run_dir: Path, lines: list[dict], *, tail: str = "", manifests=(),
           heartbeat: float | None = None) -> Path:
    (run_dir / "telemetry").mkdir(parents=True)
    text = "".join(json.dumps(line) + "\n" for line in lines) + tail
    (run_dir / "telemetry" / "timeline.jsonl").write_text(text)
    if manifests:
        (run_dir / "checkpoints").mkdir()
        for step in manifests:
            (run_dir / "checkpoints" / f"step_{step:06d}.manifest.json").write_text("{}")
    if heartbeat is not None:
        (run_dir / "heartbeat").write_text("1")
        os.utime(run_dir / "heartbeat", (heartbeat, heartbeat))
    return run_dir


def _case(tmp_path: Path, case: str) -> tuple[Path, list]:
    run_dir = tmp_path / case
    if case == "one-clean-segment":
        events, t = _steps(1, 8, 1.5)
        events.append(_span("eval", 8, t, 0.3, cat="eval"))
        return _write(run_dir, _segment(0, T0, events, T0 + t + 0.6), manifests=(4, 8)), []
    if case == "crash-and-replay":
        first, t1 = _steps(1, 6, 1.0)
        second, t2 = _steps(5, 10, 2.0)
        lines = _segment(0, T0, first, None) + _segment(1, T0 + t1 + 3.0, second, None)
        return _write(run_dir, lines, manifests=(4, 8), heartbeat=T0 + t1 + 3.0 + t2 + 0.7), []
    if case == "torn-tail":
        events, t = _steps(1, 4, 0.5)
        return _write(run_dir, _segment(0, T0, events, None), tail='{"name": "host_disp'), []
    if case == "suspended":
        first, t1 = _steps(1, 4, 1.0)
        second, _ = _steps(5, 8, 1.0)
        gap0 = T0 + t1
        lines = _segment(0, T0, first, gap0) + _segment(1, gap0 + 10.0, second, None)
        return _write(run_dir, lines), [(gap0 + 2.0, gap0 + 6.0), (gap0 - 5.0, gap0 - 4.0)]
    if case == "clock-jitter":
        # Spans that outlast the segment's own footer by a hair.
        events = [_span("host_dispatch", 1, 0.0, 1.0), _span("eval", 1, 0.9, 0.3, cat="eval")]
        return _write(run_dir, _segment(0, T0, events, T0 + 1.1)), []
    if case == "no-headers":
        return _write(run_dir, [_span("host_dispatch", 1, 0.0, 1.0)]), []
    raise AssertionError(case)


CASES = ("one-clean-segment", "crash-and-replay", "torn-tail", "suspended", "clock-jitter",
         "no-headers")


@pytest.mark.parametrize("case", CASES)
def test_ledger_matches_jax_on_hand_built_run_dirs(tmp_path, case) -> None:
    run_dir, windows = _case(tmp_path, case)
    theirs = jax_goodput.compute_goodput(run_dir, suspensions=windows)
    ours = port_goodput.compute_goodput(run_dir, suspensions=windows)
    assert ours == theirs
    if case == "no-headers":
        assert ours is None
        return
    assert ours["balance_error_sec"] == 0.0
    assert sum(ours["categories"].values()) == pytest.approx(ours["wall_clock_sec"], abs=5e-3)
    assert port_goodput.render_goodput_md(ours) == jax_goodput.render_goodput_md(theirs)
    assert port_goodput.goodput_gauges(ours) == jax_goodput.goodput_gauges(theirs)
    assert port_goodput.CATEGORIES == jax_goodput.CATEGORIES
    if case == "crash-and-replay":
        assert ours["num_segments"] == 2 and ours["categories"]["recomputed"] > 0
        assert ours["final_step"] == 8 and ours["source"]["heartbeat_used"]
    if case == "suspended":
        assert ours["categories"]["suspended"] == pytest.approx(4.0, abs=1e-3)


def test_final_committed_step_matches_jax(tmp_path) -> None:
    run_dir, _ = _case(tmp_path, "one-clean-segment")
    ckpt = run_dir / "checkpoints"
    (ckpt / "step_000012.ckpt").write_text("payload without a manifest")
    assert port_goodput.final_committed_step(ckpt) == jax_goodput.final_committed_step(ckpt) == 8
    assert port_goodput.final_committed_step(tmp_path / "none") is None


def test_a_promotions_ledger_is_refused_citing_its_item(tmp_path, capsys) -> None:
    """JAX reads ``promotions.jsonl`` through its lifecycle ledger, which
    the port does not have yet: the port refuses rather than drop it."""
    run_dir, _ = _case(tmp_path, "one-clean-segment")
    (run_dir / "promotions.jsonl").write_text("")
    with pytest.raises(NotImplementedError, match=r"queue A: lifecycle and fleet\)"):
        port_goodput.compute_goodput(run_dir)
    assert run_cli(port_main, ["goodput", "--run-dir", str(run_dir)]) == 2
    assert "lifecycle and fleet" in capsys.readouterr().err


# ---------------------------------------------------------------- end to end


def _config(tmp_path: Path) -> Path:
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(2):
        words = rng.choice(["def", "class", "return", "self", "x", "=", "\n"], size=600)
        (corpus / f"f{i}.py").write_text(" ".join(words))
    raw = {
        "schema_version": 1,
        "run": {"name": "gp", "seed": 0, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 1, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "extra": {"tokenizer": "byte"}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 8, "micro_batch_size": 2, "grad_accum_steps": 1,
                    "lr": 3e-3, "warmup_steps": 0, "log_every_steps": 1,
                    "eval_every_steps": 8, "save_every_steps": 4},
        "mlflow": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }
    path = tmp_path / "gp.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory) -> dict[str, Path]:
    """One run per package, SIGTERM'd after step 2 (so it stops at step 3
    with a preemption checkpoint) and continued by ``--auto-resume``."""
    tmp_path = tmp_path_factory.mktemp("goodput")
    cfg = _config(tmp_path)
    run_dirs = {}
    for name, main, cls in (("jax", jax_main, JaxTrainer), ("port", port_main, Trainer)):
        original = cls._log_train_interval

        def log_then_signal(self, *, step, _original=original, **kwargs):
            _original(self, step=step, **kwargs)
            if step == 2 and not getattr(log_then_signal, "fired", False):
                log_then_signal.fired = True
                os.kill(os.getpid(), signal.SIGTERM)

        argv = ["train", "--config", str(cfg), "--run-id", name, "--auto-resume", "--json"]
        cls._log_train_interval = log_then_signal
        try:
            assert run_cli(main, argv) == 0
        finally:
            cls._log_train_interval = original
        assert run_cli(main, argv) == 0
        run_dirs[name] = tmp_path / "runs" / name
    return run_dirs


def test_sigterm_and_auto_resume_give_two_segments(resumed_runs) -> None:
    ledgers = {}
    for name, run_dir in resumed_runs.items():
        theirs = jax_goodput.compute_goodput(run_dir)
        ours = port_goodput.compute_goodput(run_dir)
        assert ours == theirs, name
        ledgers[name] = ours
    jax_l, port_l = ledgers["jax"], ledgers["port"]
    for ledger in (jax_l, port_l):
        assert ledger["num_segments"] == 2
        assert [s["clean_end"] for s in ledger["segments"]] == [True, True]
        assert [(s["first_step"], s["last_step"]) for s in ledger["segments"]] == \
            [(1, 3), (4, 8)]
        assert ledger["balance_error_sec"] == 0.0
        assert ledger["final_step"] == 8
        assert ledger["categories"]["productive_train"] > 0
        assert ledger["categories"]["restart_overhead"] > 0
    assert set(port_l["categories"]) == set(jax_l["categories"])
    assert [sorted(s) for s in port_l["segments"]] == [sorted(s) for s in jax_l["segments"]]
    assert sorted(port_l) == sorted(jax_l)


@pytest.mark.parametrize("case", ["ledger", "no-ledger", "missing-dir"])
def test_goodput_exit_codes_match_jax(tmp_path, capsys, resumed_runs, case) -> None:
    run_dir = {"ledger": resumed_runs["port"], "no-ledger": tmp_path,
               "missing-dir": tmp_path / "absent"}[case]
    expected = {"ledger": 0, "no-ledger": 1, "missing-dir": 2}[case]
    outputs = []
    for main in (jax_main, port_main):
        for extra in ([], ["--json"]):
            assert run_cli(main, ["goodput", "--run-dir", str(run_dir), *extra]) == expected
            out, err = capsys.readouterr()
            outputs.append((out, json.loads(err.strip().splitlines()[-1])["error"]
                            if expected else err))
    assert outputs[2:] == outputs[:2]
    if case == "ledger":
        assert outputs[0][0].startswith(f"# Goodput — {run_dir}")
        assert json.loads(outputs[1][0])["num_segments"] == 2
