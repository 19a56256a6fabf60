"""Preemption in the port's trainer (the JAX contract of
``tests/test_preemption.py``), on the CPU.

SIGTERM during ``train`` saves a checkpoint at the step it lands in,
commits its manifest, returns with ``preempted: true`` and exits 0, and
``--auto-resume`` continues from that checkpoint to ``max_steps``. The
in-process tests send the signal from the training thread at a chosen
step (through a patched per-interval method), so nothing races the wall
clock; the subprocess test waits, with bounded waits, for the first
logged step.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import yaml
from torch_port_helpers import port_env, run_cli

from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.training.checkpoint import read_manifest
from llmtrain_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]


def _config(tmp_path: Path, *, max_steps: int, log_every: int = 1) -> Path:
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(2):
        words = rng.choice(["def", "class", "return", "self", "x", "=", "\n"], size=600)
        (corpus / f"f{i}.py").write_text(" ".join(words))
    raw = {
        "schema_version": 1,
        "run": {"name": "pre", "seed": 0, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 1, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "extra": {"tokenizer": "byte"}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": max_steps, "micro_batch_size": 2, "grad_accum_steps": 1,
                    "lr": 3e-3, "warmup_steps": 0, "log_every_steps": log_every,
                    "eval_every_steps": max_steps, "save_every_steps": max_steps},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": True},
        "output": {"root_dir": str(tmp_path / "runs")},
    }
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _sigterm_at(monkeypatch, at_step: int) -> None:
    """Send SIGTERM to this process from the training thread when the
    interval of ``at_step`` is logged: the handler latches the flag at
    once, and the step after it is the one that stops the run."""
    original = Trainer._log_train_interval

    def log_then_signal(self, *, step, **kwargs):
        original(self, step=step, **kwargs)
        if step == at_step:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(Trainer, "_log_train_interval", log_then_signal)


def _preempted_run(tmp_path: Path, monkeypatch, *, max_steps: int, run_id: str):
    cfg_path = _config(tmp_path, max_steps=max_steps)
    cfg, _, _ = load_and_validate_config(cfg_path)
    run_dir = tmp_path / "runs" / run_id
    (run_dir / "logs").mkdir(parents=True)
    _sigterm_at(monkeypatch, at_step=2)
    result = Trainer(cfg, run_dir).fit()
    monkeypatch.undo()
    return cfg_path, run_dir, result


def test_sigterm_saves_the_step_and_stops_cleanly(tmp_path, monkeypatch) -> None:
    before = signal.getsignal(signal.SIGTERM)
    _, run_dir, result = _preempted_run(tmp_path, monkeypatch, max_steps=50, run_id="r1")
    assert result.preempted is True
    assert result.final_step == 3  # signalled after step 2, honoured after step 3
    assert np.isfinite(result.final_loss)
    ckpt = run_dir / "checkpoints" / "step_000003.ckpt"
    assert ckpt.exists(), sorted((run_dir / "checkpoints").iterdir())
    manifest = read_manifest(ckpt)
    assert manifest is not None and manifest["step"] == 3
    # fit's handler does not outlive the run (it would swallow later SIGTERMs).
    assert signal.getsignal(signal.SIGTERM) == before


def test_auto_resume_continues_from_the_preemption_checkpoint(tmp_path, monkeypatch,
                                                              capsys) -> None:
    cfg_path, _, result = _preempted_run(tmp_path, monkeypatch, max_steps=6, run_id="auto")
    assert result.preempted and result.final_step == 3
    argv = ["train", "--config", str(cfg_path), "--run-id", "auto", "--auto-resume", "--json"]
    assert run_cli(port_main, argv) == 0
    resumed = json.loads(capsys.readouterr().out)["train_result"]
    assert resumed["resumed_from_step"] == 3
    assert resumed["final_step"] == 6 and resumed["preempted"] is False
    # The same six steps without the break land on the same loss.
    argv = ["train", "--config", str(cfg_path), "--run-id", "whole", "--json"]
    assert run_cli(port_main, argv) == 0
    whole = json.loads(capsys.readouterr().out)["train_result"]
    assert resumed["final_loss"] == pytest.approx(whole["final_loss"], abs=1e-5)


def test_signal_in_the_last_step_completes_the_run(tmp_path, monkeypatch) -> None:
    cfg, _, _ = load_and_validate_config(_config(tmp_path, max_steps=3))
    _sigterm_at(monkeypatch, at_step=2)  # honoured after step 3, the last
    result = Trainer(cfg, None).fit()
    assert result.preempted is False and result.final_step == 3


def test_sigterm_to_train_subprocess_exits_zero_with_checkpoint(tmp_path) -> None:
    cfg_path = _config(tmp_path, max_steps=100_000)
    env = port_env(PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "train", "--config", str(cfg_path),
         "--run-id", "sub", "--json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp_path, env=env,
    )
    run_dir = tmp_path / "runs" / "sub"
    log = run_dir / "logs" / "train.log"
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if log.exists() and "step=" in log.read_text():
                break
            if proc.poll() is not None:
                pytest.fail(f"train exited early: {proc.communicate(timeout=30)}")
            time.sleep(0.2)
        else:
            pytest.fail("training never logged a step")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    result = json.loads(out.splitlines()[-1])["train_result"]
    assert result["preempted"] is True
    assert 0 < result["final_step"] < 100_000
    ckpts = sorted((run_dir / "checkpoints").glob("step_*.ckpt"))
    assert ckpts and ckpts[-1].name == f"step_{result['final_step']:06d}.ckpt"
    assert read_manifest(ckpts[-1]) is not None
