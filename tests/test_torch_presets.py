"""The repository's presets that the port now reads, on the CPU.

The eleven ``gpt`` smoke presets on ``dummy_text`` (``gpt_resilient_smoke``
with its guard, spike detection and watchdog armed) and the two
``dummy_gpt`` presets train three steps through the port's ``train`` (gpt_quant_smoke
is refused, exit 2, citing its ROADMAP.md item); and
``gpt_pycorpus_bpe_tpu`` at a tiny width, over a corpus of standard-library
files with the tracked ``runs/pytok8k.json`` vocabulary, tracks the JAX
trainer's per-step losses from the same initial params within the
optimizer-trajectory band (atol 3e-5, rtol 1e-3). The trajectory runs in
float32: the band is the f32 one, and bf16 compute rounds differently in
the two frameworks. ``example``'s commented optimizer, EMA and profiler
keys train too, and ``ddp_smoke`` trains as two gloo processes.
``gpt_telemetry_smoke`` trains with its metrics endpoint on port 0, scraped
once mid-run, and ``ddp_mlflow`` trains as two gloo processes with rank 0
tracking into a native SQLite store under the test's directory.
"""

from __future__ import annotations

import json
import math
import shutil
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import yaml
from test_torch_train_cli import _CITES_STABLE_ITEM
from torch_port_helpers import REPO_ROOT, paired_fit, run_cli

from llmtrain_tpu_torch.cli import main as port_main

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
SMOKE_PRESETS = ("gpt_smoke", "gpt_serve_smoke", "gpt_router_smoke", "gpt_overload_smoke",
                 "gpt_fusedce_smoke", "gpt_promote_smoke", "gpt_fleet_smoke", "gpt_chaos_smoke",
                 "gpt_tune_smoke", "gpt_quant_smoke", "gpt_resilient_smoke", "dummy_smoke",
                 "example")


def _preset(name: str) -> dict:
    return yaml.safe_load((REPO_ROOT / "configs" / "presets" / f"{name}.yaml").read_text())


@pytest.mark.parametrize("name", SMOKE_PRESETS)
def test_smoke_preset_trains_three_steps(tmp_path, capsys, name: str) -> None:
    raw = _preset(name)
    trainer = raw["trainer"]
    trainer.update(max_steps=3, warmup_steps=min(trainer.get("warmup_steps", 0), 3))
    raw.setdefault("output", {})["root_dir"] = str(tmp_path / "runs")
    raw.setdefault("data", {})["cache_dir"] = str(tmp_path / "cache")
    assert raw["run"]["device"] == "cpu"
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    code = run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "r", "--json"])
    out, err = capsys.readouterr()
    if name == "gpt_quant_smoke":
        assert code == 2
        assert _CITES_STABLE_ITEM.search(err) and "queue A: parallelism)" in err, err
        return
    assert code == 0, err
    result = json.loads(out)["train_result"]
    assert result["final_step"] == 3 and math.isfinite(result["final_loss"])
    assert (tmp_path / "runs" / "r" / "checkpoints" / "step_000003.ckpt").is_file()


def test_bpe_preset_tracks_jax_at_a_tiny_width(tmp_path) -> None:
    raw = _preset("gpt_pycorpus_bpe_tpu")
    stdlib = Path(sysconfig.get_paths()["stdlib"])
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name in ("textwrap.py", "json/decoder.py", "shlex.py", "fnmatch.py"):
        shutil.copy(stdlib / name, corpus / name.replace("/", "_"))
    raw["run"]["device"] = "cpu"
    raw["model"].update(block_size=32, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                        dtype="float32")
    assert raw["model"]["vocab_size"] is None
    raw["model"]["extra"]["tokenizer"] = f"bpe:{REPO_ROOT / 'runs' / 'pytok8k.json'}"
    raw["data"]["cache_dir"] = str(tmp_path / "cache")
    raw["data"]["extra"]["globs"] = [str(corpus / "*.py")]
    raw["data"]["extra"]["val_fraction"] = 0.05
    raw["trainer"].update(max_steps=4, warmup_steps=1, micro_batch_size=8, log_every_steps=1,
                          eval_every_steps=4, save_every_steps=4)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    jax_losses, port_losses, jax_result, port_result = paired_fit(raw, tmp_path)
    assert len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(port_result.final_val_loss, jax_result.final_val_loss,
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    # The vocabulary sized the model: tied 8192 x 32 embedding.
    assert port_result.parameter_count == jax_result.parameter_count
    assert port_losses[0] == pytest.approx(math.log(8192), abs=0.5)


@pytest.mark.parametrize(
    "extra",
    [{"optimizer": "adafactor", "ema_decay": 0.999},
     {"optimizer": "lion", "profile_start_step": 2, "profile_num_steps": 1}],
    ids=["adafactor-ema", "lion-profiler"],
)
def test_example_extras_train(tmp_path, capsys, extra) -> None:
    """example.yaml's commented ``trainer.extra`` keys, switched on."""
    raw = _preset("example")
    raw["trainer"].update(max_steps=3, warmup_steps=1)
    raw["trainer"].setdefault("extra", {}).update(extra)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "example.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "x", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)["train_result"]
    assert result["final_step"] == 3 and math.isfinite(result["final_loss"])
    traces = list((tmp_path / "runs" / "x" / "logs" / "profile").glob("*.json"))
    assert len(traces) == ("profile_start_step" in extra)


def test_ddp_smoke_trains_as_two_gloo_processes(tmp_path) -> None:
    from test_torch_ddp import launch, wait

    raw = _preset("ddp_smoke")
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "ddp_smoke.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    outs = wait(launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "d", "--json"]),
                timeout=120)
    for code, _, err in outs:
        assert code == 0, err[-3000:]
    result = json.loads(outs[0][1].strip().splitlines()[-1])["train_result"]
    assert result["final_step"] == raw["trainer"]["max_steps"]
    assert math.isfinite(result["final_loss"]) and result["final_loss"] < result["first_step_loss"]


def test_telemetry_smoke_trains_and_serves_metrics(tmp_path, capsys, monkeypatch) -> None:
    """gpt_telemetry_smoke, cut to 10 steps, its endpoint on an ephemeral
    port: one scrape at the step-5 boundary carries the train and memory
    gauges, and the run writes the report, the trace and the textfile."""
    import urllib.request

    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _preset("gpt_telemetry_smoke")
    raw["trainer"].update(max_steps=10, eval_every_steps=10, save_every_steps=10)
    raw["telemetry"].update(prometheus_port=0)
    assert raw["telemetry"]["prometheus"] is True
    assert raw["telemetry"]["prometheus_host"] == "127.0.0.1"
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "gpt_telemetry_smoke.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    scraped: list[str] = []
    original = Trainer._log_train_interval

    def log_then_scrape(self, **kw):
        original(self, **kw)
        port = self._telemetry.prometheus_port
        if kw["step"] == 5 and port is not None:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                scraped.append(r.read().decode())

    monkeypatch.setattr(Trainer, "_log_train_interval", log_then_scrape)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "t", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)["train_result"]
    assert result["final_step"] == 10 and math.isfinite(result["final_loss"])
    (text,) = scraped
    for family in ("llmtrain_train_loss", "llmtrain_train_mfu", "llmtrain_mem_hbm_peak",
                   "llmtrain_run_info"):
        assert family in text, family
    run_dir = tmp_path / "runs" / "t"
    for name in ("report.json", "report.md", "telemetry/trace.json",
                 "telemetry/timeline.jsonl", "telemetry/metrics.prom"):
        assert (run_dir / name).is_file(), name


def test_ddp_mlflow_trains_as_two_gloo_processes(tmp_path) -> None:
    from test_torch_ddp import launch, wait

    from llmtrain_tpu_torch.tracking.sqlite import read_metrics, read_params, read_runs

    raw = _preset("ddp_mlflow")
    db = tmp_path / "mlflow.db"
    raw["mlflow"]["tracking_uri"] = f"sqlite:///{db}"
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "ddp_mlflow.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    outs = wait(launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "m", "--json"]),
                timeout=120)
    for code, _, err in outs:
        assert code == 0, err[-3000:]
    result = json.loads(outs[0][1].strip().splitlines()[-1])["train_result"]
    assert result["final_step"] == raw["trainer"]["max_steps"]
    (run,) = read_runs(db)
    assert (run["run_id"], run["run_name"], run["status"]) == ("m", "ddp-mlflow-smoke", "FINISHED")
    keys = {m["key"] for m in read_metrics(db, "m")}
    assert {"train/loss", "train/loss_rank_0", "train/loss_rank_1", "val/loss",
            "val/loss_rank_1", "mem/hbm_used"} <= keys
    assert read_params(db, "m")["distributed.enabled"] == "True"
