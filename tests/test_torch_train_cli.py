"""The port's ``train`` command against the JAX package's, on the CPU.

Both CLIs run in-process on one tiny config (2-layer GPT, byte tokenizer,
a seeded local_text corpus, telemetry and the tracker off so the JAX run
directory holds only what the port also writes): the same run-directory
artifacts, the same summary keys, and the same exit codes for a bad
config and an existing run directory. A feature the port has not ported
exits 2 naming ROADMAP.md; the resilience features (spike rollback, the
watchdog, injected faults) train; ``--auto-resume`` and ``--resume``
continue from the run's checkpoints; ``--dry-run`` runs forward only.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_port_helpers import run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.training.trainer import refuse_unported


def _config(tmp_path: Path, **overrides) -> Path:
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    rng = np.random.default_rng(8)
    for i in range(3):
        words = rng.choice(["def", "class", "return", "self", "x", "=", "\n"], size=900)
        (corpus / f"f{i}.py").write_text(" ".join(words))
    raw = {
        "schema_version": 1,
        "run": {"name": "tiny", "seed": 7, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 32, "d_model": 32, "n_layers": 2, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "attention": "flash",
                  "extra": {"tokenizer": "byte", "assume_packed": True}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 4, "micro_batch_size": 4, "grad_accum_steps": 1, "lr": 3e-3,
                    "warmup_steps": 1, "log_every_steps": 2, "eval_every_steps": 2,
                    "save_every_steps": 2},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": True},
        "output": {"root_dir": str(tmp_path / "runs")},
    }
    for dotted, value in overrides.items():
        node = raw
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _files(run_dir: Path) -> set[str]:
    return {str(p.relative_to(run_dir)) for p in run_dir.rglob("*")}


def _keys(tree, prefix="") -> set[str]:
    if not isinstance(tree, dict):
        return set()
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if k in ("train_result", "dry_run_resolution"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_train_writes_the_jax_run_dir_artifacts_and_summary_keys(tmp_path, capsys) -> None:
    cfg = _config(tmp_path)
    assert run_cli(jax_main, ["train", "--config", str(cfg), "--run-id", "jax", "--json"]) == 0
    jax_summary = json.loads(capsys.readouterr().out)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "port", "--json"]) == 0
    port_summary = json.loads(capsys.readouterr().out)
    runs = tmp_path / "runs"
    assert _files(runs / "port") == _files(runs / "jax")
    assert _keys(port_summary) == _keys(jax_summary)
    result = port_summary["train_result"]
    assert result["final_step"] == 4 and np.isfinite(result["final_loss"])
    assert result["parameter_count"] == jax_summary["train_result"]["parameter_count"]
    meta = json.loads((runs / "port" / "meta.json").read_text())
    assert meta.keys() == json.loads((runs / "jax" / "meta.json").read_text()).keys()
    # --resume from the first save, into a fresh run directory.
    ckpt = runs / "port" / "checkpoints" / "step_000002.ckpt"
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "resumed",
                               "--resume", str(ckpt), "--json"]) == 0
    resumed = json.loads(capsys.readouterr().out)["train_result"]
    assert resumed["resumed_from_step"] == 2
    assert resumed["final_loss"] == pytest.approx(result["final_loss"], abs=1e-5)


@pytest.mark.parametrize("case", ["bad-config", "existing-run-dir"])
def test_exit_codes_match_jax(tmp_path, capsys, case: str) -> None:
    if case == "bad-config":
        cfg = _config(tmp_path, **{"trainer.max_steps": 0})
        argv = ["train", "--config", str(cfg), "--run-id", "x"]
        expected = 2
    else:
        cfg = _config(tmp_path)
        (tmp_path / "runs" / "taken").mkdir(parents=True)
        argv = ["train", "--config", str(cfg), "--run-id", "taken"]
        expected = 1
    assert run_cli(jax_main, argv) == expected
    assert run_cli(port_main, argv) == expected
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize(
    "override",
    [{"trainer.zero.enabled": True},
     {"trainer.extra": {"optimizer": "lion"}, "distributed.mesh.sequence": 2}],
    ids=["zero", "lion-sequence"],
)
def test_unported_feature_exits_2_naming_the_roadmap(tmp_path, capsys, override) -> None:
    cfg = _config(tmp_path, **override)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "x"]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md" in err


@pytest.mark.parametrize(
    "override",
    [{"resilience.spike_detection": True, "resilience.spike_min_history": 1},
     {"resilience.watchdog.enabled": True, "resilience.watchdog.stall_timeout_sec": 60},
     {"resilience.nonfinite_guard": True, "resilience.faults.nan_loss_at_step": 2},
     {"trainer.extra": {"optimizer": "lion"}, "resilience.nonfinite_guard": True,
      "resilience.faults.nan_loss_at_step": 3}],
    ids=["spike-rollback", "watchdog", "faults", "lion"],
)
def test_resilience_features_train(tmp_path, capsys, override) -> None:
    """What the resilience refusals became: spike detection, the
    watchdog and an injected NaN window (under the guard, with AdamW and
    with Lion) train to the end with finite final losses."""
    cfg = _config(tmp_path, **override)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "x", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)["train_result"]
    assert result["final_step"] == 4 and np.isfinite(result["final_loss"])
    if "resilience.watchdog.enabled" in override:
        assert (tmp_path / "runs" / "x" / "heartbeat").is_file()


def test_auto_resume_and_dry_run(tmp_path, capsys) -> None:
    cfg = _config(tmp_path)
    argv = ["train", "--config", str(cfg), "--run-id", "auto", "--auto-resume", "--json"]
    assert run_cli(port_main, argv) == 0
    first = json.loads(capsys.readouterr().out)["train_result"]
    assert first["resumed_from_step"] is None
    assert run_cli(port_main, argv) == 0
    second = json.loads(capsys.readouterr().out)["train_result"]
    assert second["resumed_from_step"] == 4 and second["final_step"] == 4
    assert run_cli(port_main, ["train", "--config", str(cfg), "--auto-resume"]) == 2
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "dry", "--dry-run",
                               "--json"]) == 0
    dry = json.loads(capsys.readouterr().out)
    assert dry["dry_run"] is True and dry["dry_run_resolution"]["steps_executed"] == 4


def test_diverged_run_exits_1_after_the_guard_cap(tmp_path, capsys, monkeypatch) -> None:
    """Non-finite losses with the guard on: updates are skipped, and the
    run aborts (exit 1, the JAX code for a training failure) once
    ``max_consecutive_nonfinite`` consecutive updates were skipped."""
    from llmtrain_tpu_torch.models.gpt import GPTAdapter

    real = GPTAdapter.compute_loss_components

    def nan_loss(self, model, batch, **kw):
        loss_sum, tokens = real(self, model, batch, **kw)
        return loss_sum * float("nan"), tokens

    monkeypatch.setattr(GPTAdapter, "compute_loss_components", nan_loss)
    cfg = _config(tmp_path, **{"resilience.nonfinite_guard": True,
                               "resilience.max_consecutive_nonfinite": 2})
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "nan"]) == 1
    assert "consecutive optimizer updates were non-finite" in capsys.readouterr().err


def test_dense_checkpoint_resumes_under_fused_ce(tmp_path, capsys) -> None:
    """JAX lets a run change ``loss_impl`` between a checkpoint and its
    resume: the parameter tree is the same. A dense run's step-2
    checkpoint resumed under ``loss_impl: fused_ce`` (the kernels' plain
    versions on the CPU) continues to the end of the dense run, with the
    same final loss up to summation order."""
    cfg = _config(tmp_path)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "dense", "--json"]) == 0
    dense = json.loads(capsys.readouterr().out)["train_result"]
    ckpt = tmp_path / "runs" / "dense" / "checkpoints" / "step_000002.ckpt"
    cfg = _config(tmp_path, **{"model.extra.loss_impl": "fused_ce"})
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "flipped",
                               "--resume", str(ckpt), "--json"]) == 0
    flipped = json.loads(capsys.readouterr().out)["train_result"]
    assert flipped["resumed_from_step"] == 2 and flipped["final_step"] == 4
    assert flipped["final_loss"] == pytest.approx(dense["final_loss"], abs=1e-4)
    assert flipped["final_val_loss"] == pytest.approx(dense["final_val_loss"], abs=1e-4)


# ROADMAP.md's stable item names (the top of its "Open items"): a refusal
# cites one of them, never a numbered queue item.
STABLE_ITEMS = ("slice 2 deferrals", "continuous serving", "speculative decoding",
                "replica router", "int8 quantization", "rolling sliding-window cache",
                "model zoo", "parallelism", "resilience", "telemetry",
                "smoke presets and offline data", "autotune", "lifecycle and fleet")
_CITES_STABLE_ITEM = re.compile(r"\(ROADMAP\.md queue A: (" + "|".join(STABLE_ITEMS) + r")\)")


@pytest.mark.parametrize(
    "override",
    [{"distributed.mesh.sequence": 2}, {"distributed.mesh.fsdp": 2},
     {"model.extra.activation_tiers": "full:*"},
     {"distributed.enabled": True, "distributed.mesh.tensor": 2},
     {"distributed.mesh.data": 2}, {"trainer.zero.enabled": True}, {"model.remat": True},
     {"model.extra.lora": {"rank": 4}}],
    ids=["sequence", "fsdp", "activation-tiers", "data-parallel", "mesh", "zero", "remat",
         "lora"],
)
def test_refusals_cite_a_stable_roadmap_item(tmp_path, override) -> None:
    cfg, _, _ = load_and_validate_config(_config(tmp_path, **override))
    with pytest.raises(NotImplementedError) as excinfo:
        refuse_unported(cfg)
    assert _CITES_STABLE_ITEM.search(str(excinfo.value)), str(excinfo.value)


@pytest.mark.parametrize(
    "override",
    [{"trainer.extra": {"profile_start_step": 2}, "telemetry.prometheus": True},
     {"telemetry.prometheus": True}, {"mlflow.enabled": True},
     {"mlflow.enabled": True, "mlflow.backend": "tensorboard"}],
    ids=["profiler", "prometheus", "tracker", "tensorboard-tracker"],
)
def test_telemetry_features_once_refused_train(tmp_path, capsys, override) -> None:
    """What the refusals of the metrics endpoint and the tracker became:
    ``train`` runs with them; rank 0's native store records the run as
    FINISHED with the interval metrics (the TensorBoard backend writes its
    event file); the step profiler's window edges land on the timeline."""
    from llmtrain_tpu_torch.tracking.sqlite import read_metrics, read_runs

    db = tmp_path / "track.db"
    tensorboard = override.get("mlflow.backend") == "tensorboard"
    uri = str(tmp_path / "tb") if tensorboard else f"sqlite:///{db}"
    cfg = _config(tmp_path, **{"telemetry.enabled": True, "telemetry.prometheus_port": 0,
                               "telemetry.prometheus_host": "127.0.0.1",
                               "mlflow.backend": "native", "mlflow.tracking_uri": uri,
                               **override})
    assert not refuse_unported(load_and_validate_config(cfg)[0])
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "t", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)["train_result"]
    assert result["final_step"] == 4
    run_dir = tmp_path / "runs" / "t"
    assert (run_dir / "report.json").is_file() and (run_dir / "telemetry" / "trace.json").is_file()
    if tensorboard:
        (event_file,) = (tmp_path / "tb" / "llm-train-k8s" / "t").iterdir()
        assert event_file.name.startswith("events.out.tfevents.") and event_file.stat().st_size
    elif "mlflow.enabled" in override:
        assert [r["status"] for r in read_runs(db)] == ["FINISHED"]
        assert {"train/loss", "val/loss", "mem/hbm_used"} <= {m["key"] for m in read_metrics(db, "t")}
    else:
        assert not db.exists()
    events = [json.loads(line)["name"]
              for line in (run_dir / "telemetry" / "timeline.jsonl").read_text().splitlines()]
    assert ("profiler_start" in events) == ("trainer.extra" in override)


@pytest.mark.parametrize(
    "argv",
    [["serve", "--mode", "continuous", "--router"],
     ["serve", "--replicas", "2"],
     ["serve", "--mode", "continuous", "--trace-dir", "t"],
     ["serve-bench", "--router"],
     ["serve", "--mode", "continuous", "--backends", "http://127.0.0.1:1",
      "--discover", "127.0.0.1:1"],
     ["serve", "--router"]],
    ids=["serve-router", "serve-replicas", "serve-trace-dir", "bench-router",
         "serve-backends-and-discover", "serve-router-simple-mode"],
)
def test_serving_refusals_cite_a_stable_roadmap_item(tmp_path, capsys, argv) -> None:
    """The router and trace-dir flags, once refused, now run: the same argv
    (a directory without a checkpoint) answers with the JAX CLI's exit code
    and error, and so do JAX's own refusals of the router flags
    (``--backends`` with ``--discover``; ``--router`` without the
    continuous backend). No refusal cites the replica router any more."""
    cfg = _config(tmp_path)
    full = [argv[0], "--config", str(cfg), "--from", str(tmp_path), *argv[1:]]

    def answer(main) -> tuple[int, str]:
        code = run_cli(main, full)
        err = capsys.readouterr().err.strip().splitlines()
        return code, json.loads(err[-1])["error"] if err else ""

    theirs, ours = answer(jax_main), answer(port_main)
    assert ours == theirs and ours[0] != 0, (ours, theirs)
    assert "queue A: replica router" not in ours[1]


@pytest.mark.parametrize(
    "argv",
    [["serve", "--draft-config", "d.yaml", "--draft-from", "d"],
     ["serve", "--quantize", "int8"],
     ["serve-bench", "--quantize", "int8"],
     ["generate", "--prompt", "x", "--draft-config", "d.yaml", "--draft-from", "d"]],
    ids=["serve-draft", "serve-int8", "bench-int8", "generate-draft"],
)
def test_serving_flags_answer_as_jax(tmp_path, capsys, argv) -> None:
    """What the refusals of the draft and int8 flags became: the same argv
    (a directory without a checkpoint, a draft config that does not exist,
    a simple-mode server) answers with the JAX CLI's exit code and error."""
    cfg = _config(tmp_path)
    full = [argv[0], "--config", str(cfg), "--from", str(tmp_path), *argv[1:]]

    def answer(main) -> tuple[int, str]:
        code = run_cli(main, full)
        err = capsys.readouterr().err.strip().splitlines()
        return code, json.loads(err[-1])["error"] if err else ""

    theirs, ours = answer(jax_main), answer(port_main)
    assert ours == theirs and ours[0] != 0, (ours, theirs)


def test_serving_module_refusals_cite_a_stable_roadmap_item() -> None:
    """What the engine's last refusal became: the cost profile counts the
    prefill and decode steps at their largest buckets (JAX's names and
    keys), leaving the live pool untouched. (The scheduler's refusal of a
    request tracer is gone too: tracing runs.)"""
    from llmtrain_tpu_torch.models.gpt import GPT
    from llmtrain_tpu_torch.serving import ContinuousBatchingScheduler, PagedDecodeEngine
    from llmtrain_tpu_torch.telemetry.timeline import EventTimeline
    from llmtrain_tpu_torch.telemetry.tracing import Tracer

    model = GPT(vocab_size=17, block_size=16, d_model=32, n_layers=1, n_heads=2, d_ff=64)
    engine = PagedDecodeEngine(model, block_tokens=4, max_batch_slots=2)
    tracer = Tracer(EventTimeline(None))
    assert ContinuousBatchingScheduler(engine, tracer=tracer).tracer is tracer
    pool = [t.clone() for t in (*engine._cache.key, *engine._cache.value)]
    profiles = engine.cost_profile(top_k=3)
    assert [p["name"] for p in profiles] == ["prefill_T16", "decode_B2"]
    for prof in profiles:
        assert prof["flops"] > 0 and prof["roofline"]["class"] in ("compute", "memory")
        assert {"op", "count", "flops", "bytes_accessed", "flops_frac", "bytes_frac",
                "class"} == set(prof["top_ops"][0])
    totals = engine.cost_profile(full=False)
    assert [set(p) for p in totals] == [{"flops", "bytes_accessed", "transcendentals", "name",
                                         "lower_time_s"}] * 2
    assert all(torch.equal(a, b) for a, b in
               zip(pool, (*engine._cache.key, *engine._cache.value)))


def test_ema_refusal_cites_a_stable_roadmap_item(tmp_path, capsys) -> None:
    """What the refusal of ``--ema`` became: ``generate --ema`` on a
    checkpoint of a run with ``trainer.extra.ema_decay`` emits the JAX
    CLI's ids and log-probabilities; ROADMAP.md still names every stable
    item in bold."""
    cfg = _config(tmp_path, **{"trainer.extra": {"ema_decay": 0.5}})
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "ema", "--json"]) == 0
    capsys.readouterr()
    argv = ["generate", "--config", str(cfg), "--from", str(tmp_path / "runs" / "ema"),
            "--prompt", "x", "--ema", "--max-new-tokens", "4", "--temperature", "0",
            "--logprobs", "--json"]
    answers = []
    for main in (jax_main, port_main):
        assert run_cli(main, argv) == 0
        answers.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert answers[0]["output_ids"] == answers[1]["output_ids"]
    np.testing.assert_allclose(answers[1]["logprobs"], answers[0]["logprobs"], atol=2e-5)
    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text().lower()
    for item in STABLE_ITEMS:
        assert f"**{item}" in roadmap, item
