"""The port's promotion lifecycle (llmtrain_tpu_torch/lifecycle/ and
``promote``) against the JAX package's, on the CPU.

Case for case with ``tests/test_promote.py``:

* the ledger (seq, torn tail, terminal steps, the pending canary, the
  summary) and the watcher (commits, the floor, an uncommitted stage,
  pre-manifest adoption, report.json and heartbeat liveness) of both
  packages on the same files give the same answers;
* both controllers, driven with the same scripted watcher, fake fleet and
  eval losses, write the same ``(decision, step, reason)`` sequence and
  return the same result, gauges included, in every scenario of JAX's;
* the port's ``PromoteConfig``, ``/healthz`` liveness, goodput promotions
  block and CLI parser against JAX's;
* JAX's promote drill on the port's 2-replica router: a poisoned canary
  rolled back and a clean one promoted under live traffic, every live
  request bit for bit ``generate()`` under the module it was admitted
  under, the poisoned step never admitted;
* the ``promote`` round trip: a ``train`` child, then ``promote`` children
  (a promotion, then the ledger replay that promotes nothing).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_port_helpers import REPO_ROOT, jax_gpt, port_env, port_gpt, run_cli

import llmtrain_tpu.lifecycle as jax_lifecycle
import llmtrain_tpu_torch.lifecycle as port_lifecycle
from llmtrain_tpu.config.schemas import PromoteConfig as JaxPromoteConfig
from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.telemetry import goodput as jax_goodput
from llmtrain_tpu.telemetry.prometheus import render_prometheus as jax_render
from llmtrain_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from llmtrain_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from llmtrain_tpu_torch.config.schemas import PromoteConfig, RunConfig
from llmtrain_tpu_torch.telemetry import goodput as port_goodput
from llmtrain_tpu_torch.telemetry.prometheus import render_prometheus as port_render
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry
from llmtrain_tpu_torch.training.checkpoint import CheckpointManager, manifest_path

PRESET = REPO_ROOT / "configs" / "presets" / "gpt_promote_smoke.yaml"

# Each package's (lifecycle module, PromoteConfig, MetricsRegistry, render).
PKG = {
    "jax": (jax_lifecycle, JaxPromoteConfig, JaxRegistry, jax_render),
    "port": (port_lifecycle, PromoteConfig, MetricsRegistry, port_render),
}


def _without_time(entries: list[dict]) -> list[dict]:
    return [{k: v for k, v in e.items() if k != "ts_unix"} for e in entries]


# ------------------------------------------------------------------ ledger


def _ledger_case(case: str, ledger_cls, path: Path) -> dict:
    """One of JAX's ledger tests, run on ``ledger_cls``; what it observed."""
    ledger = ledger_cls(path)
    out: dict = {}
    if case == "seq-and-fresh-reader":
        ledger.append("canary_start", step=10, checkpoint="a.ckpt")
        ledger.append("promote", step=10, checkpoint="a.ckpt", scores={"x": 1})
        again = ledger_cls(path)
        again.append("canary_start", step=20)
        out["seqs"] = [e["seq"] for e in again.entries()]
        out["lines"] = len(path.read_text().splitlines())
    elif case == "unknown-decision":
        with pytest.raises(ValueError, match="unknown promotion decision") as info:
            ledger.append("demote", step=1)
        out["error"] = str(info.value)
    elif case == "torn-tail":
        ledger.append("canary_start", step=5)
        ledger.append("rollback", step=5, reason="eval_regression")
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"seq": 2, "decision": "prom')
        replay = ledger_cls(path)
        out["decisions"] = [e["decision"] for e in replay.entries()]
        out["decided"] = sorted(replay.decided_steps())
        replay.append("canary_start", step=9)
        out["next_seq"] = replay.entries()[-1]["seq"]
    elif case == "decided-terminal-only":
        for d, s in (("canary_start", 5), ("rollback", 5), ("canary_start", 9),
                     ("promote", 9), ("canary_start", 12)):
            ledger.append(d, step=s, reason="slo" if d == "rollback" else None)
        out["decided"] = sorted(ledger.decided_steps())
    elif case == "pending-canary":
        out["empty"] = ledger.pending_canary()
        ledger.append("canary_start", step=5)
        ledger.append("abort", step=5, reason="load failed")
        out["closed"] = ledger.pending_canary()
        ledger.append("canary_start", step=9)
        out["open"] = ledger.pending_canary()["step"]
    elif case == "last-promoted-and-summary":
        ledger.append("canary_start", step=5)
        ledger.append("promote", step=5, checkpoint="s5.ckpt")
        ledger.append("canary_start", step=9)
        ledger.append("rollback", step=9, reason="eval")
        out["last"] = _without_time([ledger.last_promoted()])
        summary = ledger.summary()
        assert summary.pop("path") == str(path)
        out["summary"] = summary
    else:
        raise AssertionError(case)
    out["entries"] = _without_time(ledger_cls(path).entries())
    return out


@pytest.mark.parametrize("case", ["seq-and-fresh-reader", "unknown-decision", "torn-tail",
                                  "decided-terminal-only", "pending-canary",
                                  "last-promoted-and-summary"])
def test_ledger_answers_as_jax(tmp_path, case) -> None:
    theirs = _ledger_case(case, jax_lifecycle.PromotionLedger, tmp_path / "jax.jsonl")
    ours = _ledger_case(case, port_lifecycle.PromotionLedger, tmp_path / "port.jsonl")
    assert ours == theirs
    assert port_lifecycle.DECISIONS == jax_lifecycle.DECISIONS
    assert port_lifecycle.TERMINAL_DECISIONS == jax_lifecycle.TERMINAL_DECISIONS
    if case == "seq-and-fresh-reader":
        assert ours["seqs"] == [0, 1, 2]
    if case == "torn-tail":
        assert ours["decisions"] == ["canary_start", "rollback"] and ours["decided"] == [5]


def test_ledger_lines_are_jax_lines(tmp_path) -> None:
    """Either package reads the other's file: the keys are JAX's."""
    path = tmp_path / "promotions.jsonl"
    port_lifecycle.PromotionLedger(path).append("canary_start", step=3, checkpoint="c")
    jax_lifecycle.PromotionLedger(path).append("promote", step=3, checkpoint="c",
                                               scores={"eval_loss": 1.5}, note="x")
    port_lifecycle.PromotionLedger(path).append("canary_start", step=7)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["seq"] for e in lines] == [0, 1, 2]
    assert {tuple(sorted(e)) for e in (lines[0], lines[2])} == {
        ("checkpoint", "decision", "reason", "scores", "seq", "step", "ts_unix")}
    assert (port_lifecycle.PromotionLedger(path).summary()
            == jax_lifecycle.PromotionLedger(path).summary())


# ----------------------------------------------------------------- watcher


def _host_state() -> dict:
    return {"params": {"w": np.arange(4, dtype=np.float32)},
            "opt_state": {"m": np.zeros(4, dtype=np.float32)}}


def _commit(ckpt_dir: Path, step: int) -> Path:
    return CheckpointManager(ckpt_dir, keep_last_k=10).save_host(step, _host_state(), {})


def _watch_case(case: str, lifecycle, root: Path) -> list:
    """One of JAX's watcher tests over a stream the port's manager wrote
    (each package gets its own copy: adoption writes manifests)."""
    watcher_cls = lifecycle.CheckpointWatcher
    run_dir = root / "run"
    ckpt_dir = run_dir / "checkpoints"
    seen: list = []

    def poll(watcher, **kw):
        got = watcher.poll(**kw)
        seen.append(None if got is None else (got[0].name, got[1]))

    if case == "empty":
        poll(watcher_cls(ckpt_dir))
    elif case == "floor-and-head":
        _commit(ckpt_dir, 10)
        w = watcher_cls(ckpt_dir)
        poll(w)
        poll(w, after_step=10)
        _commit(ckpt_dir, 20)
        _commit(ckpt_dir, 30)
        poll(w, after_step=10)
    elif case == "uncommitted-stage":
        _commit(ckpt_dir, 10)
        manifest_path(_commit(ckpt_dir, 20)).unlink()
        poll(watcher_cls(ckpt_dir))
    elif case == "pre-manifest-adopted":
        a, b = _commit(ckpt_dir, 5), _commit(ckpt_dir, 8)
        manifest_path(a).unlink()
        manifest_path(b).unlink()
        poll(watcher_cls(ckpt_dir))
        seen.append(manifest_path(b).is_file())
    elif case == "finished-and-heartbeat":
        ckpt_dir.mkdir(parents=True)
        w = watcher_cls(ckpt_dir, run_dir=run_dir)
        seen += [w.training_finished(), w.heartbeat_age_sec(),
                 w.training_alive(stale_sec=3600.0)]
        hb = run_dir / "heartbeat"
        hb.write_text("1")
        seen.append(w.training_alive(stale_sec=60.0))
        old = time.time() - 120.0
        os.utime(hb, (old, old))
        seen += [w.training_alive(stale_sec=60.0), w.heartbeat_age_sec() >= 100.0]
        (run_dir / "heartbeat.r1").write_text("1")
        seen += [w.training_alive(stale_sec=60.0), w.heartbeat_age_sec() < 60.0]
        (run_dir / "report.json").write_text("{}")
        seen.append(w.training_finished())
    else:
        raise AssertionError(case)
    return seen


@pytest.mark.parametrize("case", ["empty", "floor-and-head", "uncommitted-stage",
                                  "pre-manifest-adopted", "finished-and-heartbeat"])
def test_watcher_polls_as_jax(tmp_path, case) -> None:
    theirs = _watch_case(case, jax_lifecycle, tmp_path / "jax")
    ours = _watch_case(case, port_lifecycle, tmp_path / "port")
    assert ours == theirs
    expected = {
        "empty": [None],
        "floor-and-head": [("step_000010.ckpt", 10), None, ("step_000030.ckpt", 30)],
        "uncommitted-stage": [("step_000010.ckpt", 10)],
        "pre-manifest-adopted": [("step_000008.ckpt", 8), True],
        "finished-and-heartbeat": [False, None, False, True, False, True, True, True, True],
    }[case]
    assert ours == expected


def test_jax_watcher_reads_a_stream_the_port_trained(tmp_path) -> None:
    """The port's manifests are JAX's: JAX's manager verifies them."""
    _commit(tmp_path / "checkpoints", 4)
    newest = JaxCheckpointManager(tmp_path / "checkpoints").latest_valid_checkpoint()
    assert newest is not None and newest.name == "step_000004.ckpt"


# -------------------------------------------------------------- controller

_SOAK_OK = {
    "requests": 4, "completed": 4, "failed": 0, "timed_out": 0,
    "ttft_p50_ms": 8.0, "ttft_p95_ms": 10.0,
    "per_token_p50_ms": 4.0, "per_token_p99_ms": 5.0,
}


class ScriptedWatcher:
    """Head-of-stream poll over a fixed (path, step) script."""

    def __init__(self, events, *, finished=True, alive=False):
        self.events = list(events)
        self.finished = finished
        self.alive = alive

    def poll(self, *, after_step=-1):
        newer = [(p, s) for p, s in self.events if s > after_step]
        if not newer:
            return None
        path, step = newer[-1]
        return Path(path), step

    def training_finished(self):
        return self.finished

    def training_alive(self, *, stale_sec):
        return self.alive


class SequentialWatcher:
    """Commits arrive one at a time, like a live training run."""

    def __init__(self, events):
        self.events = list(events)

    def poll(self, *, after_step=-1):
        while self.events and self.events[0][1] <= after_step:
            self.events.pop(0)
        if not self.events:
            return None
        path, step = self.events[0]
        return Path(path), step

    def training_finished(self):
        return not self.events

    def training_alive(self, *, stale_sec):
        return True


class FakeFleet:
    """The controller's fleet verbs, with scriptable soak/swap outcomes."""

    def __init__(self, n=2, baseline="base-params"):
        self.replica_count = n
        self.params = [baseline] * n
        self.steps: list = [None] * n
        self.calls: list[tuple] = []
        self.soak_by_idx: dict[int, dict] = {}
        self.fleet_swap_errors: set[int] = set()
        self.canary_swap_error: str | None = None
        self.split: tuple | None = None

    def canary_swap(self, idx, params, step, ckpt):
        self.calls.append(("canary_swap", idx, step))
        if self.canary_swap_error is not None:
            raise RuntimeError(self.canary_swap_error)
        self.params[idx] = params
        self.steps[idx] = step

    def fleet_swap(self, params, step, ckpt):
        self.calls.append(("fleet_swap", step))
        out = []
        for i in range(self.replica_count):
            if i in self.fleet_swap_errors:
                out.append({"replica": f"r{i}", "error": "reload exploded"})
            else:
                self.params[i] = params
                self.steps[i] = step
                out.append({"replica": f"r{i}", "step": step})
        return out

    def set_traffic_split(self, idx, frac, seed):
        self.split = (idx, frac, seed)
        self.calls.append(("set_split", idx, frac))

    def clear_traffic_split(self):
        self.split = None
        self.calls.append(("clear_split",))

    def param_steps(self):
        return list(self.steps)

    def soak(self, idx, *, requests, seed, timeout_sec):
        self.calls.append(("soak", idx, seed))
        out = dict(_SOAK_OK)
        out.update(self.soak_by_idx.get(idx, {}))
        return out


class _Timeline:
    def __init__(self):
        self.events: list[tuple] = []

    def instant(self, name, **args):
        self.events.append(("instant", name, args.get("step"), args.get("reason")))

    def record(self, name, **args):
        self.events.append(("span", name, args.get("step"), None))


def _run_scenario(name: str, pkg: str, tmp: Path) -> dict:
    """One of JAX's controller scenarios on one package's controller."""
    lifecycle, cfg_cls, registry_cls, render = PKG[pkg]
    tmp.mkdir(parents=True, exist_ok=True)
    ledger_path = tmp / "promotions.jsonl"
    cfg = dict(poll_sec=0.001, idle_timeout_sec=5.0, soak_requests=4)
    kw: dict = dict(baseline_params="base-params", baseline_step=0,
                    baseline_checkpoint="base.ckpt", sleep=lambda s: None)
    fleet = FakeFleet()
    watcher = ScriptedWatcher([("s10.ckpt", 10)])
    registry = registry_cls(None)
    timeline = _Timeline()
    kw.update(registry=registry, timeline=timeline, load_params=lambda p: "cand")
    out: dict = {}
    if name == "clean-promotion":
        losses = {"base.ckpt": 2.0, "s10.ckpt": 1.98}
        kw.update(load_params=lambda p: f"params-{p.name}", evaluator=lambda p: losses[p.name])
    elif name == "eval-regression":
        cfg["max_eval_loss_delta"] = 0.05
        losses = {"base.ckpt": 2.0, "bad.ckpt": 2.5}
        watcher = ScriptedWatcher([("bad.ckpt", 10)])
        kw.update(load_params=lambda p: f"params-{p.name}", evaluator=lambda p: losses[p.name])
    elif name == "slo-regression":
        fleet.soak_by_idx[0] = {"ttft_p95_ms": 100.0}
        cfg["ttft_p95_slowdown"] = 2.0
        watcher = ScriptedWatcher([("slow.ckpt", 10)])
    elif name == "soak-failures":
        fleet.soak_by_idx[0] = {"failed": 2, "completed": 2}
        cfg["allow_failed_requests"] = 0
        evals: list = []
        out["evals"] = evals
        watcher = ScriptedWatcher([("crashy.ckpt", 10)])
        kw["evaluator"] = lambda p: evals.append(p) or 2.0
    elif name == "unloadable-checkpoint":
        def load(_path):
            raise ValueError("truncated msgpack")
        watcher = ScriptedWatcher([("torn.ckpt", 10)])
        kw["load_params"] = load
    elif name == "partial-fleet-swap":
        fleet = FakeFleet(n=3)
        fleet.fleet_swap_errors = {0}
        cfg["canary_replica"] = 1
    elif name == "canary-swap-fails":
        fleet.canary_swap_error = "replica gone"
    elif name == "replay-after-sigkill":
        first = lifecycle.PromotionController(
            cfg=cfg_cls(**cfg), watcher=ScriptedWatcher([("s10.ckpt", 10)]),
            fleet=FakeFleet(), ledger=lifecycle.PromotionLedger(ledger_path),
            **{k: v for k, v in kw.items() if k not in ("registry", "timeline")})
        assert first.run().promotions == 1
        out["before"] = ledger_path.read_text()
    elif name == "reopened-canary-window":
        lifecycle.PromotionLedger(ledger_path).append("canary_start", step=10,
                                                      checkpoint="s10.ckpt")
        kw["baseline_step"] = 10
    elif name == "training-death":
        now = [0.0]

        def clock():
            now[0] += 2.0
            return now[0]
        watcher = ScriptedWatcher([], finished=False, alive=False)
        kw["clock"] = clock
    elif name == "live-heartbeat":
        watcher = ScriptedWatcher([], finished=False, alive=True)
        polls = [0]

        def sleep(_s):
            polls[0] += 1
            if polls[0] >= 3:
                watcher.finished = True
        cfg["idle_timeout_sec"] = 0.5
        kw.update(clock=lambda: polls[0] * 10.0, sleep=sleep)
        out["polls"] = polls
    elif name == "max-promotions":
        cfg["max_promotions"] = 1
        watcher = ScriptedWatcher([("a.ckpt", 10), ("b.ckpt", 20)], finished=False)
    elif name == "missing-canary-replica":
        cfg["canary_replica"] = 2
        with pytest.raises(ValueError, match="out of range") as info:
            lifecycle.PromotionController(
                cfg=cfg_cls(**cfg), watcher=ScriptedWatcher([]), fleet=FakeFleet(n=2),
                ledger=lifecycle.PromotionLedger(ledger_path), **kw)
        return {"error": str(info.value)}
    else:
        raise AssertionError(name)
    ctl = lifecycle.PromotionController(
        cfg=cfg_cls(**cfg), watcher=watcher, fleet=fleet,
        ledger=lifecycle.PromotionLedger(ledger_path), **kw)
    result = ctl.run()
    entries = lifecycle.PromotionLedger(ledger_path).entries()
    out.update(
        result={k: v for k, v in vars(result).items() if k != "ledger_summary"},
        summary={k: v for k, v in result.ledger_summary.items() if k != "path"},
        ledger=[(e["decision"], e["step"], e["reason"]) for e in entries],
        scores=[e["scores"] for e in entries],
        params=fleet.params, steps=fleet.steps, calls=fleet.calls,
        events=timeline.events,
        gauges=dict(registry.latest()), counters=dict(registry.counters()),
        text=render(dict(registry.latest()), registry.counters(), {}),
        ledger_text=ledger_path.read_text() if ledger_path.exists() else "",
    )
    if "before" in out:
        out["unchanged"] = out.pop("before") == out["ledger_text"]
    return out


SCENARIOS = ["clean-promotion", "eval-regression", "slo-regression", "soak-failures",
             "unloadable-checkpoint", "partial-fleet-swap", "canary-swap-fails",
             "replay-after-sigkill", "reopened-canary-window", "training-death",
             "live-heartbeat", "max-promotions", "missing-canary-replica"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_decides_as_jax(tmp_path, name) -> None:
    theirs = _run_scenario(name, "jax", tmp_path / "jax")
    ours = _run_scenario(name, "port", tmp_path / "port")
    if name == "missing-canary-replica":
        assert ours == theirs
        return
    # The soak scores hold no wall-clock time (the fake fleet's), so the
    # whole record is comparable; only the ledger's text holds ts_unix.
    ours_text, theirs_text = ours.pop("ledger_text"), theirs.pop("ledger_text")
    assert ours == theirs
    assert len(ours_text.splitlines()) == len(theirs_text.splitlines())
    res, ledger = ours["result"], ours["ledger"]
    if name == "clean-promotion":
        assert res["status"] == "training_finished" and res["promotions"] == 1
        assert ours["params"] == ["params-s10.ckpt"] * 2 and ours["steps"] == [10, 10]
        assert [d for d, _, _ in ledger] == ["canary_start", "promote"]
        assert ours["scores"][-1]["eval_loss"] == 1.98
        assert [c[1] for c in ours["calls"] if c[0] == "soak"] == [0, 1]
        assert "llmtrain_promote_last_promoted_step 10.0" in ours["text"]
        assert "llmtrain_promote_candidates_total 1.0" in ours["text"]
    elif name == "eval-regression":
        assert ledger[-1][0] == "rollback" and ledger[-1][2].startswith("eval_regression")
        assert ours["scores"][-1]["eval_loss_delta"] == pytest.approx(0.5)
        assert ours["params"] == ["base-params"] * 2
        restore = ours["calls"].index(("canary_swap", 0, 0))
        assert ours["calls"][restore + 1:].count(("clear_split",)) == 1
    elif name == "slo-regression":
        assert ledger[-1][2].startswith("slo_regression: ttft_p95_ms")
    elif name == "soak-failures":
        assert ledger[-1][2] == "canary_request_failures: 2" and ours["evals"] == []
    elif name == "unloadable-checkpoint":
        assert ledger[-1][0] == "abort" and "truncated msgpack" in ledger[-1][2]
        assert not any(c[0] in ("canary_swap", "fleet_swap") for c in ours["calls"])
    elif name == "partial-fleet-swap":
        assert ledger[-1] == ("rollback", 10, "partial_fleet_swap: r0")
        assert ours["params"][1:] == ["base-params"] * 2
    elif name == "replay-after-sigkill":
        assert res["promotions"] == 0 and ours["calls"] == [] and ours["unchanged"]
    elif name == "reopened-canary-window":
        assert [d for d, _, _ in ledger] == ["canary_start", "canary_start", "promote"]
    elif name == "training-death":
        assert res["status"] == "training_dead"
    elif name == "live-heartbeat":
        assert res["status"] == "training_finished" and ours["polls"] == [3]
    elif name == "max-promotions":
        assert res["status"] == "max_promotions" and res["last_promoted_step"] == 20


# ------------------------------------------------------------------ config


def test_promote_config_matches_jax() -> None:
    assert PromoteConfig().model_dump() == JaxPromoteConfig().model_dump()
    assert PromoteConfig().poll_sec == 2.0 and PromoteConfig().max_promotions == 0
    for bad in ({"promote_every": 3}, {"traffic_split": 1.5}, {"ttft_p95_slowdown": 1.0}):
        for cls in (PromoteConfig, JaxPromoteConfig):
            with pytest.raises(Exception):
                cls(**bad)
    assert PromoteConfig(ttft_p95_slowdown=None).ttft_p95_slowdown is None
    raw = {"run": {"name": "t", "seed": 0, "device": "cpu"}, "model": {"name": "dummy_gpt"},
           "data": {"name": "dummy_text"}, "trainer": {"max_steps": 1, "warmup_steps": 0},
           "promote": {"max_promotions": 2, "traffic_split": 0.5}}
    assert (RunConfig.model_validate(raw).promote.model_dump()
            == JaxRunConfig.model_validate(raw).promote.model_dump())


# --------------------------------------------------------- /healthz liveness


def _health(scheduler, stale=30.0):
    from llmtrain_tpu_torch.serving.http import ServerState, _handle_health

    return _handle_health(ServerState(model=object(), tokenizer=None, step=0, checkpoint="c",
                                      scheduler=scheduler, liveness_stale_sec=stale))


def test_scheduler_alive_predicate() -> None:
    from llmtrain_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

    sched = object.__new__(ContinuousBatchingScheduler)
    sched._thread = None
    sched._beacon = time.monotonic()
    assert sched.alive(0.001)
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    sched._thread = dead
    assert not sched.alive(3600.0)
    live = threading.Thread(target=time.sleep, args=(1.0,))
    live.start()
    try:
        sched._thread = live
        sched._beacon = time.monotonic()
        assert sched.alive(30.0)
        sched._beacon = time.monotonic() - 100.0
        assert not sched.alive(30.0)
    finally:
        live.join()


def test_healthz_503_on_dead_or_stale_scheduler_and_evicted_fleet() -> None:
    class Sched:
        def __init__(self, ok):
            self.ok = ok
            self.asked_with = None

        def stats(self):
            return {"policy": "paged"}

        def alive(self, stale_sec):
            self.asked_with = stale_sec
            return self.ok

    ok = Sched(True)
    code, payload = _health(ok, stale=45.0)
    assert code == 200 and payload["status"] == "ok" and ok.asked_with == 45.0
    code, payload = _health(Sched(False))
    assert code == 503 and payload["status"] == "unhealthy" and "scheduler" in payload

    class RouterLike:
        def __init__(self, healthy):
            self.healthy = healthy

        def stats(self):
            return {"router": {"replicas_healthy": self.healthy}}

    assert _health(RouterLike(0))[0] == 503
    assert _health(RouterLike(2))[0] == 200


# ----------------------------------------------------- goodput promotions


def _timeline(run_dir: Path) -> None:
    events = [
        {"name": "segment_start", "ph": "seg", "segment_id": 0, "start_unix_time": 1000.0,
         "process_index": 0, "pid": 1},
        {"name": "host_dispatch", "cat": "train", "ph": "X", "ts_us": int(2e6),
         "dur_us": int(1e6), "step": 1, "thread": "MainThread"},
        {"name": "segment_end", "ph": "seg", "segment_id": 0, "end_unix_time": 1010.0},
    ]
    path = run_dir / "telemetry" / "timeline.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(e) + "\n" for e in events), encoding="utf-8")


@pytest.mark.parametrize("with_ledger", [True, False], ids=["ledger", "no-ledger"])
def test_goodput_promotions_block_matches_jax(tmp_path, with_ledger) -> None:
    _timeline(tmp_path)
    if with_ledger:
        ledger = port_lifecycle.PromotionLedger(tmp_path / "promotions.jsonl")
        ledger.append("canary_start", step=10, checkpoint="a.ckpt")
        ledger.append("rollback", step=10, reason="eval_regression: 0.5")
        ledger.append("canary_start", step=20, checkpoint="b.ckpt")
        ledger.append("promote", step=20, checkpoint="b.ckpt")
    ours = port_goodput.compute_goodput(tmp_path)
    theirs = jax_goodput.compute_goodput(tmp_path)
    assert ours == theirs and ("promotions" in ours) == with_ledger
    assert port_goodput.goodput_gauges(ours) == jax_goodput.goodput_gauges(theirs)
    assert port_goodput.render_goodput_md(ours) == jax_goodput.render_goodput_md(theirs)
    if with_ledger:
        block = ours["promotions"]
        assert block["decisions"]["promote"] == 1 and block["last_promoted_step"] == 20
        assert [e["decision"] for e in block["events"]] == [
            "canary_start", "rollback", "canary_start", "promote"]
        assert port_goodput.goodput_gauges(ours)["goodput/promoted_step"] == 20.0
        assert "eval_regression" in port_goodput.render_goodput_md(ours)


# --------------------------------------------------------------------- CLI


def test_parser_and_preset_match_jax() -> None:
    from llmtrain_tpu.cli import build_parser as jax_parser
    from llmtrain_tpu.config import load_and_validate_config as jax_load
    from llmtrain_tpu_torch.cli import build_parser
    from llmtrain_tpu_torch.config import load_and_validate_config

    argv = ["promote", "--config", "c.yaml", "--watch", "runs/r1", "--replicas", "3",
            "--max-promotions", "2", "--no-eval", "--json"]
    assert vars(build_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))
    cfg = load_and_validate_config(PRESET)[0]
    assert cfg.promote.model_dump() == jax_load(PRESET)[0].promote.model_dump()
    assert cfg.promote.max_promotions == 1 and cfg.serving.router.replicas == 2


@pytest.mark.parametrize("watch", ["run", "checkpoints", "flat"])
def test_resolve_watch_dirs_matches_jax(tmp_path, watch) -> None:
    from llmtrain_tpu.cli import _resolve_watch_dirs as jax_resolve
    from llmtrain_tpu_torch.cli import _resolve_watch_dirs

    run = tmp_path / "r"
    if watch == "flat":
        run.mkdir()
        (run / "step_000001.ckpt").write_text("x")
        arg = run
    else:
        (run / "checkpoints").mkdir(parents=True)
        arg = run if watch == "run" else run / "checkpoints"
    assert _resolve_watch_dirs(str(arg)) == jax_resolve(str(arg))


# ----------------------------------------------- the drill on real engines

_TINY = dict(vocab_size=32, block_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64)


def test_poisoned_canary_rolls_back_then_clean_promotes(tmp_path) -> None:
    """JAX's promote drill on the port's 2-replica router: a poisoned
    module (every weight 1e3) canaried, caught by the eval gate and rolled
    back while live traffic flows; then a clean one promoted fleet-wide.
    No live request fails, each is bit for bit ``generate()`` under the
    module it was admitted under, and the poisoned step serves none."""
    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.serving import (
        ContinuousBatchingScheduler,
        InProcessReplica,
        PagedDecodeEngine,
        ReplicaRouter,
        build_requests,
        run_loadgen,
    )

    jm, p_base = jax_gpt(seed=3, **_TINY)
    _, p_clean = jax_gpt(seed=4, **_TINY)
    base, clean, poisoned = port_gpt(jm, p_base), port_gpt(jm, p_clean), port_gpt(jm, p_clean)
    with torch.no_grad():
        for w in poisoned.parameters():
            w.fill_(1e3)

    def replica(i):
        eng = PagedDecodeEngine(base, block_tokens=4, max_batch_slots=4, prompt_buckets=[8, 16],
                                batch_buckets=[2, 4], prefix_cache=True)
        sched = ContinuousBatchingScheduler(eng, registry=registry)
        return InProcessReplica(sched.start(), f"replica{i}")

    registry = MetricsRegistry(None)
    router = ReplicaRouter([replica(0), replica(1)], registry=registry)
    try:
        modules = {"poison.ckpt": poisoned, "clean.ckpt": clean}
        losses = {"base.ckpt": 2.0, "poison.ckpt": 11.0, "clean.ckpt": 1.9}
        ledger = port_lifecycle.PromotionLedger(tmp_path / "promotions.jsonl")
        fleet = port_lifecycle.RouterFleet(router, vocab_size=32, max_new_tokens=4)
        ctl = port_lifecycle.PromotionController(
            cfg=PromoteConfig(poll_sec=0.01, soak_requests=4, soak_timeout_sec=120.0,
                              soak_seed=7, traffic_split=0.0, max_eval_loss_delta=0.05,
                              ttft_p95_slowdown=None, per_token_p99_slowdown=None),
            watcher=SequentialWatcher([("poison.ckpt", 100), ("clean.ckpt", 200)]),
            fleet=fleet, ledger=ledger, baseline_params=base, baseline_step=0,
            baseline_checkpoint="base.ckpt", load_params=lambda p: modules[p.name],
            evaluator=lambda p: losses[p.name], registry=registry,
        )
        live = build_requests(num_requests=12, seed=3, vocab_size=32, prompt_tokens_min=4,
                              prompt_tokens_max=8, max_new_tokens=4)
        block: dict = {}
        traffic = threading.Thread(target=lambda: block.update(
            run_loadgen(router, live, rate_rps=30.0, seed=5, timeout_sec=300.0)))
        traffic.start()
        result = ctl.run()
        traffic.join()

        assert result.status == "training_finished"
        assert result.promotions == 1 and result.rollbacks == 1
        entries = ledger.entries()
        assert [(e["decision"], e["step"]) for e in entries] == [
            ("canary_start", 100), ("rollback", 100), ("canary_start", 200), ("promote", 200)]
        assert entries[1]["reason"].startswith("eval_regression")
        for e in entries:
            for side in ("canary", "reference"):
                soak = e["scores"].get(side)
                if soak:
                    assert soak["failed"] == 0 and soak["timed_out"] == 0
        assert block["requests"]["failed"] == 0 and block["requests"]["timed_out"] == 0
        assert block["requests"]["completed"] == len(live)
        by_step = {0: base, 200: clean, None: base}
        for r in live:
            assert r.params_step != 100, "poisoned params served live"
            want = generate(by_step[r.params_step], r.prompt_ids[None], max_new_tokens=4,
                            temperature=0.0)
            assert r.tokens == want[0, len(r.prompt_ids):].tolist(), r.request_id
        assert fleet.param_steps() == [200, 200]
        stats = router.stats()["router"]
        assert stats["epoch_divergence"] == 0 and stats["canary"]["index"] is None
        text = port_render(dict(registry.latest()), registry.counters(), {})
        assert "llmtrain_promote_promotions_total 1.0" in text
        assert "llmtrain_promote_rollbacks_total 1.0" in text
        assert "llmtrain_promote_last_promoted_step 200.0" in text
        # The baseline's module was never written: a rollback hands it back.
        assert all(torch.equal(a, b) for a, b in zip(base.state_dict().values(),
                                                      port_gpt(jm, p_base).state_dict().values()))
    finally:
        router.close()


# ---------------------------------------------------------------- round trip


def test_promote_cli_round_trip(tmp_path) -> None:
    """``train`` then ``promote --from`` its first commit: JAX's payload,
    step 30 promoted to both replicas (the head of the stream), the
    ledger, the timeline and the gauges; then ``promote`` again with no
    ``--from``: the ledger's baseline, nothing newer, the file unchanged."""
    raw = yaml.safe_load(PRESET.read_text())
    raw["model"]["extra"] = {"tokenizer": "byte"}
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["promote"]["poll_sec"] = 0.2
    raw["logging"]["json_output"] = False
    cfg = tmp_path / "promote.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    env = port_env()

    def cli(*argv, timeout=240):
        return subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", *argv],
                              capture_output=True, text=True, env=env, timeout=timeout,
                              cwd=tmp_path)

    train = cli("train", "--config", str(cfg), "--run-id", "prm", "--json")
    assert train.returncode == 0, train.stderr[-2000:]
    run = tmp_path / "runs" / "prm"
    proc = cli("promote", "--config", str(cfg), "--watch", str(run), "--from",
               str(run / "checkpoints" / "step_000010.ckpt"), "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(payload) == ["aborts", "last_promoted_step", "ledger", "promotions",
                               "rollbacks", "status"]
    assert payload["status"] == "max_promotions" and payload["promotions"] == 1
    assert payload["last_promoted_step"] == 30
    ledger = port_lifecycle.PromotionLedger(run / "promotions.jsonl")
    entries = ledger.entries()
    assert [(e["decision"], e["step"]) for e in entries] == [("canary_start", 30),
                                                            ("promote", 30)]
    swap = entries[-1]["scores"]["fleet_swap"]
    assert [s["replica"] for s in swap] == ["replica0", "replica1"]
    assert all(s["step"] == 30 for s in swap)
    assert {"eval_loss", "baseline_eval_loss", "canary", "reference"} <= set(entries[-1]["scores"])
    names = [json.loads(line).get("name") for line in
             (run / "telemetry" / "promote_timeline.jsonl").read_text().splitlines()]
    assert "promote/promote" in names and "promote/canary_window" in names
    assert "llmtrain_promote_promotions_total 1.0" in (
        run / "telemetry" / "promote_metrics.prom").read_text()
    before = (run / "promotions.jsonl").read_text()
    again = cli("promote", "--config", str(cfg), "--watch", str(run), "--json")
    assert again.returncode == 0, again.stderr[-2000:]
    replay = json.loads(again.stdout.strip().splitlines()[-1])
    assert replay["status"] == "training_finished" and replay["promotions"] == 0
    assert (run / "promotions.jsonl").read_text() == before
    # JAX's goodput reads the ledger the port wrote, as the port's does.
    assert jax_goodput.compute_goodput(run)["promotions"] == (
        port_goodput.compute_goodput(run)["promotions"])


def test_promote_waits_for_a_first_commit_then_exits_1(tmp_path, capsys) -> None:
    """No ``--from``, no ledger and no commit within ``idle_timeout_sec``:
    exit 1 with JAX's message, as JAX's CLI."""
    from llmtrain_tpu.cli import main as jax_main
    from llmtrain_tpu_torch.cli import main as port_main

    raw = yaml.safe_load(PRESET.read_text())
    raw["promote"]["poll_sec"] = 0.05
    cfg = tmp_path / "p.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    errors = []
    for main in (jax_main, port_main):
        argv = ["promote", "--config", str(cfg), "--watch", str(run), "--idle-timeout-sec",
                "0.2"]
        assert run_cli(main, argv) == 1
        errors.append(json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"])
    assert errors[0] == errors[1] and "no committed checkpoint appeared" in errors[1]
    shutil.rmtree(run)
