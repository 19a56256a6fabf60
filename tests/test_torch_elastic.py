"""Elastic resume, the atomic commit protocol and the chaos drill of the
port against the JAX package's, on the CPU.

Units: ``classify_topology_change`` and ``resume_batch_index`` give JAX's
verdicts and messages over JAX's ``TestTopologyClassification`` cases;
the drill harness's pure functions (``deep_merge``,
``derive_segment_config``, ``aligned_log_every``, ``next_save_boundary``,
``trees_bitwise_equal``) give JAX's results; ``run_chaos`` draws JAX's
kill schedule for seeds 0-3 from the same observed commits. The manager:
JAX's ``TestManifestCommit`` cases and ``before_step`` selection on the
port's ``CheckpointManager``. Ends: elastic resume from two gloo ranks to
one process and back continues the one-process run at the same global
step (within 1e-4, JAX's bound); a changed global batch exits 2 in both
CLIs; ``chaos --cycles 3 --seed 1`` on ``gpt_chaos_smoke`` exits 0 with a
bitwise trajectory, one kill inside a checkpoint write and one corrupted
commit.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from test_torch_ddp import _summary_lines, launch, wait
from torch_port_helpers import REPO_ROOT, port_env, run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.resilience import chaos as jax_chaos
from llmtrain_tpu.resilience import elastic as jax_elastic
from llmtrain_tpu.resilience import harness as jax_harness
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.resilience import chaos as port_chaos
from llmtrain_tpu_torch.resilience import elastic as port_elastic
from llmtrain_tpu_torch.resilience import harness as port_harness
from llmtrain_tpu_torch.training.checkpoint import (
    CheckpointManager,
    manifest_path,
    read_manifest,
    resolve_resume_path,
)

CHAOS_PRESET = REPO_ROOT / "configs" / "presets" / "gpt_chaos_smoke.yaml"


def _topo(module, mesh=None, *, dp=1, global_micro=4, micro=4, accum=1, procs=1):
    sizes = {"data": 1, "fsdp": 1, "tensor": 1, "sequence": 1, "pipeline": 1, "expert": 1}
    sizes.update(mesh or {})
    return module.describe_topology(sizes, data_parallel=dp, global_micro_batch=global_micro,
                                    micro_batch_size=micro, grad_accum_steps=accum,
                                    num_processes=procs)


# JAX's TestTopologyClassification cases: (saved, current) keyword sets.
_TOPOLOGIES = {
    "identical": (dict(mesh={"data": 2}, dp=2, micro=2), dict(mesh={"data": 2}, dp=2, micro=2)),
    "batch-axis-resize": (dict(mesh={"data": 4}, dp=4, micro=1),
                          dict(mesh={"data": 2}, dp=2, micro=2)),
    "processes-change": (dict(mesh={"data": 2}, dp=2, micro=2, procs=2),
                         dict(mesh={"data": 1}, dp=1, micro=4, procs=1)),
    "unknown-saved": (None, dict()),
    "tensor-degree": (dict(mesh={"tensor": 2}), dict()),
    "global-batch": (dict(mesh={"data": 2}, dp=2, micro=2, global_micro=4),
                     dict(global_micro=2, micro=2)),
    "grad-accum": (dict(accum=2), dict(accum=1)),
}


def _verdict(module, case: str):
    saved, current = _TOPOLOGIES[case]
    try:
        return module.classify_topology_change(
            None if saved is None else _topo(module, **saved), _topo(module, **current))
    except module.TopologyMismatchError as exc:
        return ("TopologyMismatchError", str(exc))


@pytest.mark.parametrize("case", sorted(_TOPOLOGIES))
def test_topology_classification_matches_jax(case: str) -> None:
    assert _verdict(port_elastic, case) == _verdict(jax_elastic, case)
    assert _topo(port_elastic, {"data": 2}, dp=2) == _topo(jax_elastic, {"data": 2}, dp=2)


def test_resume_batch_index_matches_jax() -> None:
    for data, step, accum in ((None, 10, 2), ({"consumed_micro_batches": 26}, 10, 2),
                              ({}, 3, 1), ({"consumed_micro_batches": None}, 4, 3)):
        got = port_elastic.resume_batch_index(data, step=step, grad_accum_steps=accum)
        assert got == jax_elastic.resume_batch_index(data, step=step, grad_accum_steps=accum)
    assert port_elastic.ELASTIC_AXES == jax_elastic.ELASTIC_AXES
    assert port_elastic.MODEL_AXES == jax_elastic.MODEL_AXES


def test_harness_pure_functions_match_jax(tmp_path) -> None:
    base = {"trainer": {"log_every_steps": 4, "extra": {"a": 1}}, "mlflow": {"enabled": True},
            "model": {"extra": {"x": 1, "y": [1, 2]}}}
    over = {"model": {"extra": {"y": [3]}}, "trainer": {"extra": {"b": 2}}}
    assert port_harness.deep_merge(base, over) == jax_harness.deep_merge(base, over)
    kw = dict(root_dir=str(tmp_path), max_steps=18, save_every=6, log_every=3,
              faults={"kill_at_step": 5})
    assert (port_harness.derive_segment_config(base, overrides=over, **kw)
            == jax_harness.derive_segment_config(base, overrides=over, **kw))
    assert port_chaos._derive_config(base, **kw) == jax_chaos._derive_config(base, **kw)
    for save, log in ((6, 3), (6, 4), (5, 5), (12, 1)):
        assert port_harness.aligned_log_every(save, log) == jax_harness.aligned_log_every(save,
                                                                                          log)
    for last, save, steps in ((0, 6, 18), (6, 6, 18), (17, 6, 18), (18, 6, 18)):
        assert (port_harness.next_save_boundary(last, save, steps)
                == jax_harness.next_save_boundary(last, save, steps))
    a = {"p": {"w": np.ones(3), "b": np.zeros(2)}}
    for b in ({"p": {"w": np.ones(3), "b": np.zeros(2)}},
              {"p": {"w": np.ones(3), "b": np.full(2, 1e-9)}},
              {"p": {"w": np.ones(3)}}, {"p": {"w": np.ones(3, np.float32), "b": np.zeros(2)}},
              {"p": {"w": np.ones(3), "b": {"c": np.zeros(2)}}}):
        assert port_harness.trees_bitwise_equal(a, b) == jax_harness.trees_bitwise_equal(a, b)
    bf16 = {"w": torch.ones(3, dtype=torch.bfloat16)}
    assert port_harness.trees_bitwise_equal(bf16, {"w": torch.ones(3, dtype=torch.bfloat16)}) \
        is None
    assert "/w" in port_harness.trees_bitwise_equal(
        bf16, {"w": torch.full((3,), 2.0, dtype=torch.bfloat16)})
    assert port_harness.train_segment_command("c.yaml", "r")[1:3] == ["-m",
                                                                        "llmtrain_tpu_torch"]


class _Stop(Exception):
    pass


def _schedule(module, tmp_path: Path, seed: int, monkeypatch) -> list:
    """``run_chaos``'s kill schedule with the segments simulated: a kill at
    step k leaves the newest save before k committed; a kill inside a
    checkpoint write leaves that save adopted; a corrupted boundary is
    skipped. Returns each cycle's label and faults in order, the reference
    first (the port runs it beside the killed segments, on a thread)."""
    save = 6
    state = {"newest": 0}
    plan: list = []
    reference: list = []

    def run_segment(cfg_path, run_id, *, timeout_sec, label):
        faults = yaml.safe_load(Path(cfg_path).read_text())["resilience"]["faults"]
        (reference if label == "reference" else plan).append((label, faults))
        if label == "final":
            raise _Stop
        if label == "reference":
            return subprocess.CompletedProcess([], 0, stdout='{"train_result": {}}', stderr="")
        kill = faults.get("kill_at_step")
        if faults.get("kill_during_checkpoint"):
            state["newest"] = kill
        else:
            saves = [s for s in range(save, kill, save) if s != faults.get(
                "corrupt_checkpoint_at_step")]
            state["newest"] = max([state["newest"], *saves])
        return subprocess.CompletedProcess([], -9, stdout="", stderr="")

    monkeypatch.setattr(module, "_run_segment", run_segment)
    monkeypatch.setattr(module, "_newest_committed_step", lambda d: state["newest"])
    monkeypatch.setattr(module, "_assert_newest_loadable", lambda d: state["newest"])
    monkeypatch.setattr(module, "_segment_resumed_step",
                        lambda log, offset: None)
    with pytest.raises(_Stop):
        module.run_chaos(CHAOS_PRESET, cycles=4, seed=seed, save_every=save,
                         work_dir=tmp_path / module.__name__.split(".")[0] / str(seed))
    return reference + plan


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_kill_schedule_matches_jax(tmp_path, monkeypatch, seed: int) -> None:
    port_plan = _schedule(port_chaos, tmp_path, seed, monkeypatch)
    assert port_plan == _schedule(jax_chaos, tmp_path, seed, monkeypatch)
    assert port_plan[0] == ("reference", {}) and port_plan[-1] == ("final", {})
    assert port_plan[2][1]["kill_during_checkpoint"] is True  # cycle 1: inside a write


# ------------------------------------------------------------------ the manager


def _host_state(step: int) -> dict:
    return {"params": {"w": np.full(4, float(step), np.float32)}, "opt_state": {}}


def test_save_publishes_manifest_and_commits_in_order(tmp_path) -> None:
    commits = []
    mgr = CheckpointManager(tmp_path / "c", on_commit=lambda step, path: commits.append(step))
    target = mgr.save_host(1, _host_state(1), {"a": 1},
                           manifest_extra={"topology": {"mesh": {"data": 2}}})
    manifest = read_manifest(target)
    assert manifest["step"] == 1
    assert [f["name"] for f in manifest["files"]] == ["step_000001.ckpt",
                                                       "step_000001.ckpt.sha256"]
    for entry in manifest["files"]:
        blob = (tmp_path / "c" / entry["name"]).read_bytes()
        assert entry["bytes"] == len(blob)
        assert entry["sha256"] == hashlib.sha256(blob).hexdigest()
    assert manifest["topology"] == {"mesh": {"data": 2}}
    assert mgr.verify_manifest(target)
    mgr.save_host_async(2, _host_state(2), {})
    mgr.close()
    assert commits == [1, 2]
    assert manifest_path(tmp_path / "step_000007.ckpt").name == "step_000007.manifest.json"


def test_uncommitted_torn_and_dangling_stages(tmp_path) -> None:
    d = tmp_path / "c"
    mgr = CheckpointManager(d, keep_last_k=10)
    mgr.save_host(1, _host_state(1), {})
    newest = mgr.save_host(2, _host_state(2), {})
    staged = d / "step_000003.ckpt"
    shutil.copy(newest, staged)  # valid bytes, no sidecar, no manifest
    assert CheckpointManager(d).latest_valid_checkpoint().name == "step_000002.ckpt"
    assert resolve_resume_path(str(d), tmp_path).name == "step_000002.ckpt"
    (d / "step_000004.ckpt").write_bytes(b"torn bytes")
    (d / "step_000005.ckpt.tmp").write_bytes(b"half a stage")
    (d / "step_000002.ckpt").unlink()
    mgr.save_host(6, _host_state(6), {})
    names = sorted(p.name for p in d.iterdir())
    assert "step_000004.ckpt" not in names and "step_000005.ckpt.tmp" not in names
    assert not (d / "step_000002.manifest.json").exists()
    assert read_manifest(staged)["synthesized"] is True
    assert CheckpointManager(d).latest_valid_checkpoint().name == "step_000006.ckpt"


def test_resave_corruption_prune_and_legacy_migration(tmp_path) -> None:
    d = tmp_path / "c"
    mgr = CheckpointManager(d)
    mgr.save_host(1, _host_state(1), {})
    first = read_manifest(d / "step_000001.ckpt")
    mgr.save_host(1, _host_state(9), {})
    assert first["files"][0]["sha256"] != read_manifest(d / "step_000001.ckpt")["files"][0][
        "sha256"]
    newest = mgr.save_host(2, _host_state(2), {})
    newest.write_bytes(newest.read_bytes()[: newest.stat().st_size // 2])
    assert CheckpointManager(d).latest_valid_checkpoint().name == "step_000001.ckpt"
    pruned = CheckpointManager(tmp_path / "p", keep_last_k=1)
    for step in (1, 2, 3):
        pruned.save_host(step, _host_state(step), {})
    assert sorted(p.name for p in (tmp_path / "p").glob("*.manifest.json")) == [
        "step_000003.manifest.json"]
    legacy = CheckpointManager(tmp_path / "l")
    legacy.save_host(1, _host_state(1), {})
    legacy.save_host(2, _host_state(2), {})
    for p in (tmp_path / "l").glob("*.manifest.json"):
        p.unlink()
    got = CheckpointManager(tmp_path / "l").latest_valid_checkpoint()
    assert got.name == "step_000002.ckpt" and read_manifest(got)["synthesized"] is True
    assert int(CheckpointManager.load(got)["step"]) == 2


def test_before_step_selection_for_the_rollback(tmp_path) -> None:
    d = tmp_path / "c"
    mgr = CheckpointManager(d, keep_last_k=10)
    for step in (4, 8, 12):
        mgr.save_host(step, _host_state(step), {})
    assert mgr.latest_valid_checkpoint(before_step=12).name == "step_000008.ckpt"
    assert mgr.latest_valid_checkpoint(before_step=9).name == "step_000008.ckpt"
    assert mgr.latest_valid_checkpoint(before_step=4) is None
    (d / "step_000008.ckpt").write_bytes(b"damaged")
    assert CheckpointManager(d).latest_valid_checkpoint(before_step=12).name == \
        "step_000004.ckpt"


# ------------------------------------------------------------------ elastic resume


def _corpus_raw(tmp_path: Path, *, micro: int, distributed: bool, **trainer) -> dict:
    """A topology-independent dataset (local_text sizes itself from the
    file, not from the batch), JAX's ``_elastic_cfg`` model."""
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    (corpus / "corpus.txt").write_text("the quick brown fox jumps over the lazy dog. " * 200)
    return {
        "schema_version": 1,
        "run": {"name": "el", "seed": 7, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 8, "vocab_size": 256, "dropout": 0.0,
                  "d_model": 32, "n_heads": 2, "d_ff": 64, "n_layers": 1,
                  "extra": {"tokenizer": "byte"}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "corpus.txt")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 6, "micro_batch_size": micro, "grad_accum_steps": 1,
                    "lr": 3e-3, "warmup_steps": 0, "log_every_steps": 3,
                    "eval_every_steps": 100, "save_every_steps": 3, **trainer},
        "distributed": {"enabled": distributed, "timeout_sec": 60},
        "mlflow": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


def _cfg(tmp_path: Path, name: str, raw: dict) -> Path:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def test_ws2_to_ws1_and_back_match_at_same_global_step(tmp_path, capsys) -> None:
    """Save with two gloo ranks (micro 2 x 2), resume in one process with
    the global micro-batch kept (micro 4), and back: both continue the
    one-process run to its final loss within 1e-4 (reduction order), the
    manifests record both topologies, and the resume stamps the
    ``elastic_reshard`` instant."""
    ws2 = _cfg(tmp_path, "ws2.yaml", _corpus_raw(tmp_path, micro=2, distributed=True))
    ws1 = _cfg(tmp_path, "ws1.yaml", _corpus_raw(tmp_path, micro=4, distributed=False))
    outs = wait(launch(tmp_path, ["train", "--config", str(ws2), "--run-id", "ws2", "--json"]))
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-3000:]
    runs = tmp_path / "runs"
    manifest = read_manifest(runs / "ws2" / "checkpoints" / "step_000006.ckpt")
    assert manifest["topology"]["data_parallel"] == 2
    assert manifest["topology"]["global_micro_batch"] == 4
    assert run_cli(port_main, ["train", "--config", str(ws1), "--run-id", "ws1", "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)["train_result"]
    assert run_cli(port_main, ["train", "--config", str(ws1), "--run-id", "down", "--json",
                               "--resume", str(runs / "ws2" / "checkpoints" /
                                               "step_000003.ckpt")]) == 0
    out, err = capsys.readouterr()
    down = json.loads(out)["train_result"]
    assert "elastic resume: topology changed (data: 2 -> 1, processes: 2 -> 1)" in err
    assert down["resumed_from_step"] == 3 and down["final_step"] == 6
    assert down["final_loss"] == pytest.approx(ref["final_loss"], abs=1e-4)
    events = [json.loads(line)["name"] for line in
              (runs / "down" / "telemetry" / "timeline.jsonl").read_text().splitlines()]
    assert "elastic_reshard" in events
    outs = wait(launch(tmp_path, ["train", "--config", str(ws2), "--run-id", "up", "--json",
                                  "--resume", str(runs / "ws1" / "checkpoints" /
                                                  "step_000003.ckpt")]))
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-3000:]
    up = json.loads(_summary_lines(outs[0][1])[-1])["train_result"]
    assert up["resumed_from_step"] == 3
    assert up["final_loss"] == pytest.approx(ref["final_loss"], abs=1e-4)


def test_changed_global_batch_exits_2_in_both_clis(tmp_path, capsys) -> None:
    """A resume whose global micro-batch differs from the checkpoint's
    re-deals the data stream: both CLIs refuse it, exit 2, naming the
    global micro-batch."""
    for main, name in ((jax_main, "jax"), (port_main, "port")):
        raw = _corpus_raw(tmp_path, micro=8, distributed=False, max_steps=2,
                          save_every_steps=2)
        saved = _cfg(tmp_path, f"{name}.yaml", raw)
        assert run_cli(main, ["train", "--config", str(saved), "--run-id", name]) == 0
        raw["trainer"]["micro_batch_size"] = 16
        changed = _cfg(tmp_path, f"{name}_16.yaml", raw)
        ckpt = tmp_path / "runs" / name / "checkpoints" / "step_000002.ckpt"
        capsys.readouterr()
        assert run_cli(main, ["train", "--config", str(changed), "--run-id", f"{name}2",
                              "--resume", str(ckpt)]) == 2
        assert "global micro-batch" in capsys.readouterr().err


# ------------------------------------------------------------------ the drill


def test_chaos_cycles_3_is_bitwise_recoverable(tmp_path) -> None:
    """``chaos --cycles 3 --seed 1`` on gpt_chaos_smoke: three SIGKILLed
    ``train`` segments (one inside a checkpoint write, one after
    corrupting the newest commit), then the final one; the newest commit
    loads after each, and the trajectory and final state are bitwise the
    uninterrupted run's."""
    proc = subprocess.run(
        [sys.executable, "-m", "llmtrain_tpu_torch", "chaos", "--config", str(CHAOS_PRESET),
         "--cycles", "3", "--seed", "1", "--work-dir", str(tmp_path / "drill"), "--json"],
        cwd=REPO_ROOT, env=port_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bitwise_match"] is True
    assert result["kills_delivered"] == 3 and result["kill_during_checkpoint_cycles"] == 1
    assert [c["mode"] for c in result["cycles"]] == ["kill", "kill_during_checkpoint",
                                                     "corrupt_then_kill"]
    assert result["final_loss"] == result["reference_final_loss"]
    assert result["trajectory_points_compared"] > 0
    assert result["goodput"]["balance_error_sec"] == pytest.approx(0.0, abs=0.05)
