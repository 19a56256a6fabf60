"""Data parallel in the port against one process and against the JAX
package, on the CPU: ``python -m llmtrain_tpu_torch train`` as two gloo
processes on ``configs/presets/ddp_smoke.yaml`` (micro batch 4 a rank)
against the port's one-process run at micro batch 8 and JAX's paired run
on the same global batches, with equal and with unequal token counts per
rank; rank-0-only artifacts; SIGTERM to one rank; resume at the same world
size and, elastically, at another; the rendezvous exit codes of both
CLIs.

Every child has its own timeout and a small ``distributed.timeout_sec``.
Band: the optimizer trajectory's, atol 3e-5 and rtol 1e-3.
"""

from __future__ import annotations

import json
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import yaml
from torch_port_helpers import REPO_ROOT, paired_fit, port_env, run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu_torch.cli import main as port_main

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
COMPARED_STEPS = 10

# Zero the attention mask past 2 + index % 5 tokens of each example, so
# the ranks' halves of a batch hold different token counts. Run in the
# children and, through exec, in this process.
MASKING = """
def masked_examples(real):
    def get_examples(self, indices):
        out = real(self, indices)
        mask = out["attention_mask"].copy()
        for row, index in enumerate(indices):
            mask[row, 2 + int(index) % 5:] = 0
        out["attention_mask"] = mask
        return out
    return get_examples
"""
exec(MASKING)  # defines masked_examples

# The children: the port's CLI, with the per-step losses and the evals'
# val/loss written exactly (the log line rounds them), each interval's
# tokens/s beside the rate its MFU was computed from and, with
# MASK_ROWS, the masked dummy_text.
CHILD = MASKING + """
import json, os, sys
import numpy as np
import llmtrain_tpu_torch.training.trainer as trainer_module
from llmtrain_tpu_torch.training.trainer import Trainer

out_path = os.environ["LOSSES_OUT"] + "." + os.environ["RANK"]
real_log, real_eval = Trainer._log_train_interval, Trainer._evaluate
real_mfu = trainer_module.compute_mfu

def log_interval(self, **kw):
    rate = kw["interval_tokens"] / kw["interval_time"]
    with open(out_path, "a") as f:
        f.write(json.dumps({"losses": [float(x) for x in np.asarray(kw["losses_host"])],
                            "tokens_per_sec": rate}) + "\\n")
    return real_log(self, **kw)

def mfu(tokens_per_sec_per_chip, **kw):
    with open(out_path, "a") as f:
        f.write(json.dumps({"mfu_rate": tokens_per_sec_per_chip}) + "\\n")
    return real_mfu(tokens_per_sec_per_chip, **kw)

trainer_module.compute_mfu = mfu

def evaluate(self, step, max_steps, eval_fn=None):
    metrics = real_eval(self, step, max_steps, eval_fn)
    with open(out_path, "a") as f:
        f.write(json.dumps({"val": [step, metrics["val/loss"]]}) + "\\n")
    return metrics

Trainer._log_train_interval, Trainer._evaluate = log_interval, evaluate
if os.environ.get("MASK_ROWS"):
    from llmtrain_tpu_torch.data.dummy_text import _DummyTextDataset
    _DummyTextDataset.get_examples = masked_examples(_DummyTextDataset.get_examples)
from llmtrain_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _raw(tmp_path: Path, **trainer) -> dict:
    """ddp_smoke.yaml, every step logged. dummy_text sizes its data by
    max_steps x micro_batch_size, capped at 128 examples: max_steps 128
    gives every run (4 a rank, 8 in one process, JAX's 1 per device) the
    same capped set."""
    raw = yaml.safe_load((REPO_ROOT / "configs/presets/ddp_smoke.yaml").read_text())
    raw["trainer"].update({"max_steps": 128, "log_every_steps": 1, "eval_every_steps": 5,
                           "save_every_steps": 64, **trainer})
    raw["distributed"]["timeout_sec"] = 60
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    return raw


def _write(tmp_path: Path, raw: dict, name: str) -> Path:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def launch(tmp_path: Path, argv: list[str], *, world: int = 2, timeout: float = 180,
           env: dict | None = None) -> list:
    """``world`` ranks of the port's ``train`` over gloo on a free local
    port, started together; returns the Popen objects (the caller waits)."""
    port = str(free_port())
    procs = []
    for rank in range(world):
        child_env = port_env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=port, LOSSES_OUT=str(tmp_path / "losses"),
                             **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD, *argv], cwd=tmp_path,
                                      env=child_env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def wait(procs, timeout: float = 180) -> list[tuple[int, str, str]]:
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:  # a rank left in a collective must not outlive the test
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def recorded(tmp_path: Path, rank: int = 0) -> tuple[list[float], dict[int, float]]:
    losses, vals = [], {}
    for line in (tmp_path / f"losses.{rank}").read_text().splitlines():
        rec = json.loads(line)
        losses += rec.get("losses", [])
        if "val" in rec:
            vals[int(rec["val"][0])] = rec["val"][1]
    return losses, vals


def mfu_rates(tmp_path: Path, rank: int = 0) -> list[tuple[float, float]]:
    """(tokens/s of the interval, the rate its MFU was computed from)."""
    recs = [json.loads(line) for line in (tmp_path / f"losses.{rank}").read_text().splitlines()]
    rates = [r["tokens_per_sec"] for r in recs if "tokens_per_sec" in r]
    per_card = [r["mfu_rate"] for r in recs if "mfu_rate" in r]
    assert len(rates) == len(per_card) > 0
    return list(zip(rates, per_card))


def _summary_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith("{")]


def _init_checkpoint(tmp_path: Path, jax_cfg_path: Path, port_cfg_path: Path) -> Path:
    """JAX's initial params (the init ``paired_fit`` carries over) as a
    step-0 checkpoint of the port with a fresh optimizer state."""
    from flax import serialization
    from flax.linen import meta as nn_meta

    import jax
    from llmtrain_tpu.config import load_and_validate_config as jax_load
    from llmtrain_tpu.tracking.base import NullTracker
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.cli import _save_fresh_checkpoint, _tool_model
    from llmtrain_tpu_torch.config import load_and_validate_config

    jax_trainer = JaxTrainer(jax_load(jax_cfg_path)[0], None, NullTracker())
    params = jax.device_get(serialization.to_state_dict(nn_meta.unbox(jax_trainer._state.params)))
    cfg = load_and_validate_config(port_cfg_path)[0]
    return _save_fresh_checkpoint(cfg, _tool_model(cfg), params, tmp_path / "init")


@pytest.mark.parametrize("masked", [False, True], ids=["equal-tokens", "unequal-tokens"])
def test_two_ranks_match_one_process_and_jax(tmp_path, monkeypatch, masked) -> None:
    if masked:
        from llmtrain_tpu.data.dummy_text import _DummyTextDataset as JaxDummy
        from llmtrain_tpu_torch.data.dummy_text import _DummyTextDataset

        for cls in (JaxDummy, _DummyTextDataset):
            monkeypatch.setattr(cls, "get_examples", masked_examples(cls.get_examples))
    one = _raw(tmp_path, micro_batch_size=8)
    one["distributed"]["enabled"] = False
    jax_losses, port_losses, jax_result, port_result = paired_fit(one, tmp_path,
                                                                  steps=COMPARED_STEPS)
    two_cfg = _write(tmp_path, _raw(tmp_path), "two.yaml")
    init = _init_checkpoint(tmp_path, tmp_path / "paired_jax.yaml", two_cfg)
    procs = launch(tmp_path, ["train", "--config", str(two_cfg), "--run-id", "two", "--json",
                              "--resume", str(init)],
                   env={"MASK_ROWS": "1"} if masked else None)
    outs = wait(procs)
    for code, _, err in outs:
        assert code == 0, err[-3000:]
    two_losses, two_vals = recorded(tmp_path)
    assert recorded(tmp_path, 1)[0] == two_losses  # every rank logs the global loss
    # The tokens/s logged are the global batch's; MFU is one card's share.
    for rate, per_card in mfu_rates(tmp_path):
        assert per_card == pytest.approx(rate / 2, rel=1e-12)
    assert len(port_losses) == len(jax_losses) == COMPARED_STEPS
    np.testing.assert_allclose(two_losses[:COMPARED_STEPS], port_losses, atol=TRAJ_ATOL,
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(two_losses[:COMPARED_STEPS], jax_losses, atol=TRAJ_ATOL,
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(two_vals[COMPARED_STEPS], port_result.final_val_loss,
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(two_vals[COMPARED_STEPS], jax_result.final_val_loss,
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    # Rank 0 alone writes the run dir, the checkpoints and the summary.
    assert [p.name for p in (tmp_path / "runs").iterdir()] == ["two"]
    ckpts = sorted(p.name for p in (tmp_path / "runs" / "two" / "checkpoints").glob("*.ckpt"))
    assert ckpts == ["step_000064.ckpt", "step_000128.ckpt"]
    assert _summary_lines(outs[1][1]) == []
    summary = json.loads(_summary_lines(outs[0][1])[-1])
    assert summary["train_result"]["final_step"] == 128
    manifest = json.loads((tmp_path / "runs" / "two" / "checkpoints"
                           / "step_000128.manifest.json").read_text())
    topology = manifest["topology"]
    assert (topology["num_processes"], topology["data_parallel"],
            topology["global_micro_batch"], topology["mesh"]["data"]) == (2, 2, 8, 2)


def test_one_rank_group_keeps_the_single_process_arithmetic(tmp_path, capsys) -> None:
    """``distributed.enabled`` with one process (a one-rank gloo group over
    an in-memory store): the token-count and gradient all-reduces run, and
    the losses and eval are those of the run without the group, bit for
    bit."""
    answers = {}
    for enabled in (False, True):
        raw = _raw(tmp_path, max_steps=6, eval_every_steps=3, save_every_steps=6)
        raw["distributed"]["enabled"] = enabled
        cfg = _write(tmp_path, raw, f"one_{enabled}.yaml")
        assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", f"one_{enabled}",
                                   "--json"]) == 0
        answers[enabled] = json.loads(capsys.readouterr().out)["train_result"]
    for key in ("first_step_loss", "final_loss", "final_val_loss"):
        assert answers[True][key] == answers[False][key], key


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path) -> None:
    raw = _raw(tmp_path, max_steps=100_000, log_every_steps=5, eval_every_steps=100_000,
               save_every_steps=100_000)
    cfg = _write(tmp_path, raw, "long.yaml")
    procs = launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "pre", "--json"])
    log = tmp_path / "runs" / "pre" / "logs" / "train.log"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if log.exists() and "step=" in log.read_text():
                break
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.1)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = wait(procs, timeout=120)
    for code, _, err in outs:
        assert code == 0, err[-3000:]
    result = json.loads(_summary_lines(outs[0][1])[-1])["train_result"]
    assert result["preempted"] is True and 0 < result["final_step"] < 100_000
    assert result["final_step"] % 5 == 0  # the consensus runs at log boundaries
    step = result["final_step"]
    ckpts = sorted((tmp_path / "runs" / "pre" / "checkpoints").glob("step_*.ckpt"))
    assert [p.name for p in ckpts] == [f"step_{step:06d}.ckpt"]
    assert f"stopping cleanly at step {step}" in outs[1][2]
    assert _summary_lines(outs[1][1]) == []


def test_resume_continues_at_the_same_world_size_only(tmp_path, capsys) -> None:
    # max_steps 32: dummy_text's 128-example cap, so the one-process run
    # below (micro batch 8) trains on the same examples as the two ranks.
    raw = _raw(tmp_path, max_steps=32, log_every_steps=2, eval_every_steps=16,
               save_every_steps=16)
    cfg = _write(tmp_path, raw, "short.yaml")
    outs = wait(launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "whole",
                                  "--json"]))
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-3000:]
    whole = json.loads(_summary_lines(outs[0][1])[-1])["train_result"]
    ckpt = tmp_path / "runs" / "whole" / "checkpoints" / "step_000016.ckpt"
    outs = wait(launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "resumed",
                                  "--resume", str(ckpt), "--json"]))
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-3000:]
    resumed = json.loads(_summary_lines(outs[0][1])[-1])["train_result"]
    assert resumed["resumed_from_step"] == 16
    assert resumed["final_loss"] == whole["final_loss"]
    assert resumed["final_val_loss"] == whole["final_val_loss"]
    # One process from the two-rank checkpoint at micro batch 4 x 2: the
    # same global batch, so an elastic resume that continues the two-rank
    # trajectory within the band (the gradient sum's order differs).
    raw1 = {**raw, "distributed": {**raw["distributed"], "enabled": False},
            "trainer": {**raw["trainer"], "micro_batch_size": 2 * raw["trainer"]["micro_batch_size"]}}
    cfg1 = _write(tmp_path, raw1, "one.yaml")
    assert run_cli(port_main, ["train", "--config", str(cfg1), "--run-id", "elastic",
                               "--resume", str(ckpt), "--json"]) == 0
    elastic = json.loads(_summary_lines(capsys.readouterr().out)[-1])["train_result"]
    assert elastic["resumed_from_step"] == 16
    assert np.isclose(elastic["final_loss"], whole["final_loss"], atol=TRAJ_ATOL, rtol=TRAJ_RTOL)


def test_bad_rendezvous_config_exits_2_in_both_clis(tmp_path, monkeypatch, capsys) -> None:
    """WORLD_SIZE without a rank: the topology cannot work (2)."""
    cfg = _write(tmp_path, _raw(tmp_path, max_steps=2), "bad.yaml")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("RANK", raising=False)
    answers = []
    for main in (jax_main, port_main):
        code = run_cli(main, ["train", "--config", str(cfg), "--run-id", "bad"])
        answers.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])))
    assert answers[0] == answers[1] and answers[0][0] == 2, answers
    assert "process id is unset" in answers[0][1]["error"]


def test_rendezvous_timeout_exits_75_in_both_clis(tmp_path, monkeypatch, capsys) -> None:
    """A rendezvous that fails for a transient cause (here a timeout) is
    75 in both CLIs, after the retries."""
    import llmtrain_tpu.cli as jax_cli
    import llmtrain_tpu_torch.distributed as port_dist

    def timed_out(*args, **kwargs):
        raise TimeoutError("coordinator did not answer")

    monkeypatch.setattr(jax_cli, "setup_distributed", timed_out)
    monkeypatch.setattr(port_dist, "setup_distributed", timed_out)
    raw = _raw(tmp_path, max_steps=2)
    raw["resilience"] = {"retry_attempts": 2, "retry_base_delay": 0.0}
    cfg = _write(tmp_path, raw, "timeout.yaml")
    answers = []
    for main in (jax_main, port_main):
        code = run_cli(main, ["train", "--config", str(cfg), "--run-id", "t"])
        answers.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])))
    assert answers[0] == answers[1] and answers[0][0] == 75, answers


def test_unreachable_coordinator_exits_75(tmp_path) -> None:
    """Rank 1 of 2 against a local port nobody listens on: the port's
    rendezvous times out (distributed.timeout_sec 3, one attempt) and
    ``train`` exits 75. (JAX's client aborts the process from inside
    jaxlib there, ROADMAP.md queue C.)"""
    raw = _raw(tmp_path, max_steps=2)
    raw["distributed"]["timeout_sec"] = 3
    raw["resilience"] = {"retry_attempts": 1}
    cfg = _write(tmp_path, raw, "dead.yaml")
    env = port_env(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
    proc = subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", "train", "--config",
                           str(cfg), "--run-id", "dead"], cwd=tmp_path, env=env, text=True,
                          capture_output=True, timeout=120)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert "distributed init failed" in proc.stderr
    assert not (tmp_path / "runs").exists()
