"""The port's telemetry (llmtrain_tpu_torch/telemetry/) against the JAX
package's, on the CPU.

* The metrics registry: the same publishes, counters, histograms and
  flushes give the same live values, history, tracker calls and error
  counts, with a working and with a failing tracker.
* The ``Telemetry`` facade: the same calls write the same run files, the
  same report keys, the same Prometheus families and register the same
  artifacts; with ``telemetry.enabled: false`` it writes nothing.
* The Prometheus endpoint on port 0, scraped, and its failed bind.
* The memory monitor: JAX's sample keys, peaks and headroom channel; the
  CUDA allocator's counters read under JAX's names.
* The slice as a whole: one tiny GPT trained 12 steps by both trainers
  from the same initial params, telemetry on and the native tracker: the
  same files, report keys, per-step timeline events, Prometheus families
  and tracker keys and params, the losses within the optimizer-trajectory
  band (atol 3e-5, rtol 1e-3, f32); and the port's losses bit-identical
  with telemetry off.

JAX's in-process trainer runs data parallel over the session's eight
virtual CPU devices, so it also logs per-shard ``*_rank_<r>`` metrics a
one-process run does not have; those are left out of the key comparisons
(the two-process preset run in test_torch_presets.py logs them).
"""

from __future__ import annotations

import json
import logging
import re
import socket
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401
import yaml
from flax import serialization
from flax.linen import meta as nn_meta

from llmtrain_tpu.config import load_and_validate_config as jax_load_config
from llmtrain_tpu.telemetry import Telemetry as JaxTelemetry
from llmtrain_tpu.telemetry import memory as jax_memory
from llmtrain_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from llmtrain_tpu.telemetry.timeline import EventTimeline as JaxTimeline
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.telemetry import Telemetry
from llmtrain_tpu_torch.telemetry import memory as port_memory
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry
from llmtrain_tpu_torch.telemetry.timeline import EventTimeline

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
_RANK_KEY = re.compile(r"_rank_\d+")
# report.json keys JAX has and the port does not: the analytic activation
# footprint comes from JAX's mesh planner (ROADMAP.md queue A: autotune).
_REPORT_DIVERGENCES = {"memory": {"activation_bytes", "activation_bytes_offloaded"}}
_METRIC_DIVERGENCES = {"mem/activation_bytes", "mem/activation_bytes_offloaded"}
_FAMILY_DIVERGENCES = {"llmtrain_mem_activation_bytes", "llmtrain_mem_activation_bytes_offloaded"}


class _RecordingTracker:
    def __init__(self) -> None:
        self.calls: list[tuple[dict, int | None]] = []
        self.params: list[dict] = []
        self.artifacts: list[tuple[str, str | None]] = []

    def start_run(self, run_id, run_name=None):
        pass

    def log_params(self, params):
        self.params.append(params)

    def log_metrics(self, metrics, step=None):
        self.calls.append((dict(metrics), step))

    def log_artifact(self, local_path, artifact_path=None):
        self.artifacts.append((local_path, artifact_path))

    def end_run(self, status="FINISHED"):
        pass


class _FailingTracker(_RecordingTracker):
    def log_metrics(self, metrics, step=None):
        raise RuntimeError("backend down")

    def log_params(self, params):
        raise RuntimeError("backend down")

    def log_artifact(self, local_path, artifact_path=None):
        raise RuntimeError("backend down")


def _drive_registry(registry) -> None:
    registry.publish({"train/loss": 2.5, "train/lr": 1e-3}, step=1)
    registry.publish({"train/loss": 2.4}, step=2)
    registry.inc("ckpt/saves")
    registry.inc("ckpt/saves", 2)
    registry.observe("serve/ttft_ms", 12.0, buckets=(10.0, 100.0), trace_id="t1")
    registry.flush(2)
    registry.publish({"val/loss": 2.6, "mem/hbm_used": 5.0}, step=3)
    registry.flush(3)
    registry.flush(4)  # nothing pending
    registry.safe_log_params({"model": {"d": 1}})
    registry.safe_log_artifact("/x/report.json", "telemetry")


@pytest.mark.parametrize("tracker_cls", [_RecordingTracker, _FailingTracker, None],
                         ids=["recording", "failing", "none"])
def test_registry_matches_jax(tracker_cls) -> None:
    results = []
    for cls in (JaxRegistry, MetricsRegistry):
        tracker = tracker_cls() if tracker_cls is not None else None
        registry = cls(tracker)
        _drive_registry(registry)
        hist = registry.histograms()["serve/ttft_ms"].snapshot()
        results.append((registry.latest(), registry.counters(), registry.history(),
                        registry.tracker_errors, hist[1:],
                        None if tracker is None else (tracker.calls, tracker.params,
                                                      tracker.artifacts)))
    assert results[1] == results[0]
    if tracker_cls is _FailingTracker:
        assert results[1][3] == 4 and results[1][1]["telemetry/tracker_errors"] == 4


def test_serving_registry_needs_no_tracker() -> None:
    registry = MetricsRegistry()
    registry.publish({"serve/queue_depth": 3})
    assert registry.latest() == {"serve/queue_depth": (3.0, None)}
    assert registry.flush() is True and registry.history() == []


# ---------------------------------------------------------------- configs


def _corpus(tmp_path: Path) -> Path:
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    rng = np.random.default_rng(8)
    for i in range(3):
        words = rng.choice(["def", "class", "return", "self", "x", "=", "\n"], size=900)
        (corpus / f"f{i}.py").write_text(" ".join(words))
    return corpus


def _raw(tmp_path: Path, **telemetry) -> dict:
    corpus = _corpus(tmp_path)
    return {
        "schema_version": 1,
        "run": {"name": "tele", "seed": 7, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 32, "d_model": 32, "n_layers": 2,
                  "n_heads": 2, "d_ff": 64, "dropout": 0.0, "attention": "flash",
                  "extra": {"tokenizer": "byte", "assume_packed": True}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 12, "micro_batch_size": 8, "grad_accum_steps": 1,
                    "lr": 3e-3, "warmup_steps": 1, "log_every_steps": 4,
                    "eval_every_steps": 6, "save_every_steps": 6},
        "telemetry": telemetry,
        "mlflow": {"enabled": True, "backend": "native"},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


def _configs(tmp_path: Path, raw: dict, jax_micro: int | None = None):
    """(JAX RunConfig, port RunConfig) of one raw config; JAX's micro batch
    is per device (``jax_micro``), so both train on the same global batch."""
    out = []
    for name, micro in (("jax", jax_micro), ("port", None)):
        cfg = json.loads(json.dumps(raw))
        if micro is not None:
            cfg["trainer"]["micro_batch_size"] = micro
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        out.append((jax_load_config if name == "jax" else load_and_validate_config)(path)[0])
    return out


def _families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def _files(root: Path) -> set[str]:
    return {p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file()}


def _key_tree(report: dict) -> dict[str, set[str]]:
    """Top-level keys, and each dict section's keys (minus divergences)."""
    out = {"": set(report)}
    for section, value in report.items():
        if isinstance(value, dict):
            out[section] = set(value) - _REPORT_DIVERGENCES.get(section, set())
    return out


# ---------------------------------------------------------------- facade


def _drive_facade(tel, run_dir: Path) -> dict | None:
    tel.start()
    tl = tel.timeline
    with tl.span("data_wait", cat="data", step=1):
        pass
    tl.record("host_dispatch", step=1, t0=0.0, t1=0.0)
    with tl.span("checkpoint_save", cat="ckpt", step=1):
        pass
    tl.instant("checkpoint_commit", cat="ckpt", step=1)
    tel.record_opt_state_bytes({"opt_state_bytes": 8.0, "opt_state_bytes_per_device": 8.0,
                                "opt_state_bytes_host": 0.0})
    tel.metrics.publish({"train/loss": 2.0, "train/mfu": 0.1}, step=1)
    tel.metrics.inc("checkpoint/commits")
    tel.flush(1)
    report = tel.finalize(train_result={"final_step": 1, "final_loss": 2.0}, run_id="r")
    tel.register_artifacts()
    tel.close()
    return report


def test_facade_writes_jax_s_files_and_keys(tmp_path) -> None:
    cfgs = _configs(tmp_path, _raw(tmp_path))
    outs = []
    for cfg, cls in zip(cfgs, (JaxTelemetry, Telemetry)):
        run_dir = tmp_path / cls.__module__.split(".")[0]
        run_dir.mkdir()
        tracker = _RecordingTracker()
        report = _drive_facade(cls(cfg, run_dir, tracker), run_dir)
        outs.append(dict(
            files=_files(run_dir), keys=_key_tree(report),
            saved=_key_tree(json.loads((run_dir / "report.json").read_text())),
            families=_families((run_dir / "telemetry" / "metrics.prom").read_text()),
            artifacts=[(Path(p).relative_to(run_dir).as_posix(), a)
                       for p, a in tracker.artifacts],
            tracked=[sorted(m) for m, _ in tracker.calls],
            goodput=set(report["goodput"]["categories"]),
        ))
    jax_out, port_out = outs
    assert port_out == jax_out
    assert {"report.json", "report.md", "telemetry/timeline.jsonl", "telemetry/trace.json",
            "telemetry/metrics.prom"} <= port_out["files"]


def test_disabled_facade_is_a_no_op_but_still_tracks(tmp_path) -> None:
    (cfg,) = _configs(tmp_path, _raw(tmp_path, enabled=False))[1:]
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    tracker = _RecordingTracker()
    tel = Telemetry(cfg, run_dir, tracker)
    assert _drive_facade(tel, run_dir) is None
    assert tel.timeline.events() == [] and tel.memory is None
    assert _files(run_dir) == set()
    assert tracker.calls == [({"train/loss": 2.0, "train/mfu": 0.1}, 1)]


# ---------------------------------------------------------------- prometheus


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.read().decode()


def test_endpoint_on_port_0_is_scraped_as_jax_s(tmp_path) -> None:
    cfgs = _configs(tmp_path, _raw(tmp_path, prometheus=True, prometheus_host="127.0.0.1",
                                   prometheus_port=0))
    scraped = []
    for cfg, cls in zip(cfgs, (JaxTelemetry, Telemetry)):
        tel = cls(cfg, None, None)
        tel.start()
        port = tel.prometheus_port
        assert port is not None and port > 0
        tel.metrics.publish({"train/loss": 2.0}, step=1)
        tel.metrics.inc("ckpt/saves")
        text = _scrape(port)
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            _scrape(port, "/nope")
        assert excinfo.value.code == 404
        tel.close()
        assert tel.prometheus_port is None
        scraped.append(text.replace("process_index=", "pi="))
    assert _families(scraped[1]) == _families(scraped[0])
    assert "llmtrain_train_loss 2.0" in scraped[1] and "llmtrain_ckpt_saves_total 1.0" in scraped[1]
    assert scraped[1] == scraped[0]


def test_endpoint_bind_failure_degrades_to_a_warning(tmp_path) -> None:
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        port = busy.getsockname()[1]
        (cfg,) = _configs(tmp_path, _raw(tmp_path, prometheus=True,
                                         prometheus_host="127.0.0.1",
                                         prometheus_port=port))[1:]
        tel = Telemetry(cfg, None, None)
        records: list[logging.LogRecord] = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        logger = logging.getLogger("llmtrain")
        logger.addHandler(handler)
        try:
            tel.start()
        finally:
            logger.removeHandler(handler)
        assert tel.prometheus_port is None
        assert any("failed to bind" in r.getMessage() for r in records)
        tel.close()
    finally:
        busy.close()


# ---------------------------------------------------------------- memory


def test_memory_monitor_keys_match_jax_on_the_cpu() -> None:
    jax_mon, port_mon = jax_memory.MemoryMonitor(), port_memory.MemoryMonitor()
    jax_sample, port_sample = jax_mon.sample(1), port_mon.sample(1)
    assert set(port_sample) == set(jax_sample)
    assert set(port_mon.peaks()) == set(jax_mon.peaks())
    # The CPU sources differ (a recorded divergence): JAX sums its live
    # arrays, the port reads the resident set and has no tensor inventory.
    assert jax_mon.source == "live_arrays" and port_mon.source == "host_rss"
    assert port_sample["mem/hbm_used"] == port_sample["mem/host_rss"] > 0
    assert port_sample["mem/live_arrays"] == port_sample["mem/live_array_bytes"] == 0.0


def test_headroom_channel_matches_jax(monkeypatch, caplog) -> None:
    stats = {"bytes_in_use": 95.0e9, "peak_bytes_in_use": 96.0e9, "bytes_limit": 100.0e9}
    monkeypatch.setattr(jax_memory, "_device_memory_stats", lambda: dict(stats))
    monkeypatch.setattr(port_memory, "_device_memory_stats",
                        lambda device: dict(stats, live_blocks=3.0, live_bytes=7.0))
    runs = []
    for module, timeline_cls in ((jax_memory, JaxTimeline), (port_memory, EventTimeline)):
        tl = timeline_cls()
        mon = module.MemoryMonitor(headroom_warn_frac=0.9, timeline=tl)
        samples = []
        for step, used in ((7, 95e9), (8, 95e9), (9, 10e9), (10, 95e9)):
            stats["bytes_in_use"] = used
            samples.append({k: v for k, v in mon.sample(step).items()
                            if k.startswith("mem/hbm")})
        runs.append((samples, mon.headroom_warnings, mon.source,
                     tl.event_counts().get("hbm_headroom"),
                     [e["args"]["used_frac"] for e in tl.events()
                      if e["name"] == "hbm_headroom"]))
    assert runs[1] == runs[0]
    assert runs[1][1] == 2 and runs[1][2] == "memory_stats"


def test_memory_monitor_reads_the_cuda_allocator(monkeypatch) -> None:
    """On the card the figures are the caching allocator's counters; the
    limit is the card's total memory."""
    counters = {"allocated_bytes.all.current": 3.0e9, "allocated_bytes.all.peak": 5.0e9,
                "active.all.current": 42, "active_bytes.all.current": 3.5e9}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: counters)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: type("P", (), {"total_memory": 80e9})())
    mon = port_memory.MemoryMonitor(device=torch.device("cuda", 0))
    sample = mon.sample(1)
    assert mon.source == "memory_stats"
    assert (sample["mem/hbm_used"], sample["mem/hbm_peak"], sample["mem/hbm_limit"]) == \
        (3.0e9, 5.0e9, 80e9)
    assert sample["mem/live_arrays"] == 42 and sample["mem/live_array_bytes"] == 3.5e9
    assert sample["mem/hbm_used_frac"] == pytest.approx(3.0 / 80.0)
    assert mon.peaks()["hbm_peak_bytes"] == 5.0e9


# ---------------------------------------------------------------- the slice


def _step_events(run_dir: Path, max_step: int) -> dict[int, set[tuple[str, str]]]:
    out: dict[int, set[tuple[str, str]]] = {}
    for line in (run_dir / "telemetry" / "timeline.jsonl").read_text().splitlines():
        event = json.loads(line)
        step = event.get("step")
        if step is not None and 1 <= step <= max_step:
            out.setdefault(step, set()).add((event["name"], event.get("cat", "")))
    return out


def _paired_trainers(tmp_path: Path, raw: dict, tag: str):
    """JAX's and the port's trainer on ``raw`` with run dirs and native
    trackers, the port's model carrying JAX's initial params."""
    from llmtrain_tpu.registry import initialize_registries
    from llmtrain_tpu.tracking import SqliteTracker as JaxSqlite
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.interop import flax_params_to_state_dict
    from llmtrain_tpu_torch.tracking import SqliteTracker
    from llmtrain_tpu_torch.training.trainer import Trainer

    devices = len(jax.devices())
    jax_cfg, port_cfg = _configs(tmp_path, raw, raw["trainer"]["micro_batch_size"] // devices)
    initialize_registries()
    out = {}
    for name, cfg, tracker_cls, trainer_cls in (("jax", jax_cfg, JaxSqlite, JaxTrainer),
                                                 ("port", port_cfg, SqliteTracker, Trainer)):
        run_dir = tmp_path / f"{name}-{tag}"
        run_dir.mkdir()
        db = tmp_path / f"{name}-{tag}.db"
        tracker = tracker_cls(f"sqlite:///{db}", "exp")
        tracker.start_run(f"{name}-{tag}")
        out[name] = (trainer_cls(cfg, run_dir, tracker), run_dir, tracker, db)
    params = jax.device_get(serialization.to_state_dict(
        nn_meta.unbox(out["jax"][0]._state.params)))
    out["port"][0].model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return out


def _losses(trainer_cls, trainer) -> list[float]:
    losses: list[float] = []
    original = trainer_cls._log_train_interval

    def log_interval(self, **kw):
        losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
        return original(self, **kw)

    from unittest import mock

    with mock.patch.object(trainer_cls, "_log_train_interval", log_interval):
        trainer.fit()
    return losses


def test_slice_writes_what_jax_writes(tmp_path) -> None:
    from llmtrain_tpu.tracking.sqlite import read_metrics as jax_read_metrics
    from llmtrain_tpu.tracking.sqlite import read_params as jax_read_params
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.tracking.sqlite import read_metrics, read_params
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _raw(tmp_path)
    raw["trainer"]["log_every_steps"] = 1
    pair = _paired_trainers(tmp_path, raw, "on")
    results = {}
    for name, cls in (("jax", JaxTrainer), ("port", Trainer)):
        trainer, run_dir, tracker, db = pair[name]
        losses = _losses(cls, trainer)
        tracker.end_run()
        report = json.loads((run_dir / "report.json").read_text())
        read_m, read_p = (jax_read_metrics, jax_read_params) if name == "jax" else \
            (read_metrics, read_params)
        run_id = f"{name}-on"
        results[name] = dict(
            losses=losses, report=report, files=_files(run_dir),
            keys=_key_tree(report),
            events=_step_events(run_dir, 12),
            families={f for f in _families((run_dir / "telemetry" / "metrics.prom").read_text())
                      if not _RANK_KEY.search(f) and f not in _FAMILY_DIVERGENCES},
            tracked={m["key"] for m in read_m(db, run_id)
                     if not _RANK_KEY.search(m["key"]) and m["key"] not in _METRIC_DIVERGENCES},
            # JAX's micro batch is per device (module doc): the one value
            # the two configs differ in.
            params={k: v for k, v in read_p(db, run_id).items()
                    if k != "trainer.micro_batch_size"},
            perf=set(report["perf_attribution"]["executables"][0]),
        )
    jax_r, port_r = results["jax"], results["port"]
    np.testing.assert_allclose(port_r["losses"], jax_r["losses"], atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    for key in ("final", "first_logged", "min", "val_final"):
        np.testing.assert_allclose(port_r["report"]["loss"][key], jax_r["report"]["loss"][key],
                                   atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    for key in ("files", "keys", "events", "families", "tracked", "params", "perf"):
        assert port_r[key] == jax_r[key], key
    assert {"report.json", "report.md", "telemetry/timeline.jsonl", "telemetry/trace.json",
            "telemetry/metrics.prom"} <= port_r["files"]
    goodput = port_r["report"]["goodput"]
    assert sum(goodput["categories"].values()) == pytest.approx(goodput["wall_clock_sec"],
                                                                abs=2e-3)
    mfu = port_r["report"]["perf_attribution"]["mfu"]
    assert mfu["reconciled"] is True

    # Telemetry off: nothing written, the same losses bit for bit.
    off = _raw(tmp_path, enabled=False)
    off["trainer"]["log_every_steps"] = 1
    pair_off = _paired_trainers(tmp_path, off, "off")
    trainer, run_dir, tracker, _ = pair_off["port"]
    losses_off = _losses(Trainer, trainer)
    tracker.end_run()
    assert losses_off == port_r["losses"]
    assert not (run_dir / "telemetry").exists() and not (run_dir / "report.json").exists()
