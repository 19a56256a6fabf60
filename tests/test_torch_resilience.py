"""The port's fault-tolerance layer against the JAX package's, on the CPU.

Units, equal to JAX's on the same inputs: the loss-spike detector over
hypothesis-drawn loss sequences (flags, trend, ``state()``), the fault
plan's one-shot and exact-step rules (``FaultPlan``), and the exit-code
walk over chains through ``RollbackBudgetExceededError``,
``InjectedFault`` and the moved ``TopologyMismatchError``. The non-finite
guard: a skipped update leaves AdamW, Adafactor and Lion (with the EMA)
bit-identical and an applied one equals the unguarded update bit for bit;
the guarded train step reads the host at most once a step. Checkpoints:
a failing background write fails the run within a log interval, a save
whose host state is mutated in place afterwards still writes the values
at save time, and the resilience payload either package writes restores
``rollback_count``, ``data_offset`` and the detector's state in the other.
The slice as a whole: one tiny GPT with the guard, a NaN window and an
injected spike trained by both trainers from the same params: the same
skipped steps, the same rollback (spike step, restored step, data offset,
``rollback_count``), the same ``rollback``, ``fault_*`` and
``nonfinite_skip`` instants, and per-step losses within the optimizer
band (atol 3e-5, rtol 1e-3); past ``max_rollbacks`` both CLIs exit 1; and
the consensus rollback of two gloo processes.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_ddp import _summary_lines, launch, wait
from test_torch_exit_codes import _from, _raised
from torch_port_helpers import paired_fit, run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.config.schemas import FaultInjectionConfig as JaxFaultConfig
from llmtrain_tpu.resilience import elastic as jax_elastic
from llmtrain_tpu.resilience import exit_codes as jax_codes
from llmtrain_tpu.resilience import faults as jax_faults
from llmtrain_tpu.resilience import guard as jax_guard
from llmtrain_tpu.resilience import spike as jax_spike
from llmtrain_tpu.training import checkpoint as jax_ckpt
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.config.schemas import FaultInjectionConfig as PortFaultConfig
from llmtrain_tpu_torch.config.schemas import TrainerConfig
from llmtrain_tpu_torch.data.sampler import DeterministicSampler
from llmtrain_tpu_torch.resilience import elastic as port_elastic
from llmtrain_tpu_torch.resilience import exit_codes as port_codes
from llmtrain_tpu_torch.resilience import faults as port_faults
from llmtrain_tpu_torch.resilience import guard as port_guard
from llmtrain_tpu_torch.resilience import spike as port_spike
from llmtrain_tpu_torch.training import checkpoint as port_ckpt
from llmtrain_tpu_torch.training.optimizer import build_optimizer
from llmtrain_tpu_torch.training.trainer import Trainer

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3


def _raw(tmp_path: Path, *, resilience: dict, **trainer) -> dict:
    """A tiny GPT on dummy_text, every step logged: max_steps 128 keeps
    dummy_text at its 128-example cap whatever the micro batch (runs stop
    early through ``fit(steps)``)."""
    return {
        "schema_version": 1,
        "run": {"name": "resil", "seed": 5, "device": "cpu", "deterministic": True},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "vocab_size": 64, "attention": "flash",
                  "extra": {"tokenizer": "byte"}},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 128, "micro_batch_size": 8, "grad_accum_steps": 1, "lr": 3e-3,
                    "warmup_steps": 2, "log_every_steps": 2, "eval_every_steps": 1000,
                    "save_every_steps": 4, **trainer},
        "resilience": resilience,
        "mlflow": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


def _write(tmp_path: Path, raw: dict, name: str) -> Path:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


# ------------------------------------------------------------------ units


_LOSS = st.one_of(st.floats(0.01, 20.0), st.floats(50.0, 5e3), st.just(float("nan")),
                  st.just(float("inf")))


@settings(max_examples=60, deadline=None)
@given(losses=st.lists(_LOSS, min_size=1, max_size=50), factor=st.floats(1.5, 8.0),
       beta=st.floats(0.05, 0.99), min_history=st.integers(1, 8))
def test_spike_detector_matches_jax(losses, factor, beta, min_history) -> None:
    kw = dict(factor=factor, beta=beta, min_history=min_history)
    jax_det, port_det = jax_spike.LossSpikeDetector(**kw), port_spike.LossSpikeDetector(**kw)
    for loss in losses:
        assert port_det.observe(loss) == jax_det.observe(loss)
        assert port_det.trend == jax_det.trend and port_det.armed == jax_det.armed
    assert port_det.state() == jax_det.state()
    restored = port_spike.LossSpikeDetector(**kw)
    restored.load_state(jax_det.state())
    assert restored.state() == jax_det.state() and restored.trend == jax_det.trend


class _Corruptible:
    """The manager surface ``maybe_corrupt_checkpoint`` touches."""

    def __init__(self, path: Path) -> None:
        self.path = path

    def wait_pending(self) -> bool:
        return True

    def latest_checkpoint(self) -> Path:
        return self.path


def _script(case: str, plan, tmp_path: Path, kills: list) -> list:
    """Drive one plan through a fixed sequence of calls; every result,
    raised error and observer call in order."""
    out: list = []
    plan.observer = lambda kind, step: out.append(("observer", kind, step))

    def call(name, fn):
        try:
            out.append((name, fn()))
        except Exception as exc:  # noqa: BLE001 — the failure is the result
            out.append((name, type(exc).__name__, str(exc)))

    if case == "checkpoint-kill":
        for step in (3, 6, 12):
            call(f"take@{step}", lambda s=step: plan.take_checkpoint_kill(s))
    elif case == "checkpoint-kill-first-save":
        for step in (2, 4):
            call(f"take@{step}", lambda s=step: plan.take_checkpoint_kill(s))
    elif case == "spike":
        losses = np.arange(1.0, 5.0, dtype=np.float32)
        for first in (1, 5, 5, 9):
            call(f"poison@{first}", lambda f=first: plan.poison_host_losses(losses, f).tolist())
    elif case == "nan-window":
        call("nan_window", plan.nan_window)
    elif case == "flaky":
        for kind in ("dataset_load", "distributed_init", "other"):
            wrapped = plan.flaky(kind, lambda: "ok")
            for i in range(4):
                call(f"{kind}#{i}", wrapped)
    elif case in ("sigterm", "preempt", "kill"):
        for step in (1, 2, 3, 3, 4):
            method = plan.maybe_kill if case == "kill" else plan.maybe_sigterm
            call(f"{case}@{step}", lambda s=step, m=method: m(s))
        out.append(("kills", list(kills)))
    elif case == "hang":
        for step, site in ((1, "host"), (2, "prefetcher"), (2, "host"), (2, "host")):
            call(f"hang@{step}/{site}", lambda s=step, w=site: plan.maybe_hang(s, site=w))
    elif case in ("corrupt-truncate", "corrupt-garbage"):
        path = tmp_path / f"{type(plan).__module__.split('.')[0]}.ckpt"
        path.write_bytes(bytes(range(256)) * 2)
        mgr = _Corruptible(path)
        for step in (1, 2, 3):
            call(f"corrupt@{step}", lambda s=step: plan.maybe_corrupt_checkpoint(s, mgr))
        out.append(("bytes", path.read_bytes()))
    return out


_PLANS = {
    "checkpoint-kill": dict(kill_at_step=6, kill_during_checkpoint=True),
    "checkpoint-kill-first-save": dict(kill_during_checkpoint=True),
    "spike": dict(spike_loss_at_step=6, spike_loss_scale=10.0),
    "nan-window": dict(nan_loss_at_step=3, nan_loss_steps=2),
    "flaky": dict(dataset_load_failures=2),
    "sigterm": dict(sigterm_at_step=3),
    "preempt": dict(preempt_at_step=2),
    "kill": dict(kill_at_step=3),
    "hang": dict(hang_at_step=2, hang_duration_sec=0.01, hang_in_prefetcher=True),
    "corrupt-truncate": dict(corrupt_checkpoint_at_step=2, corrupt_mode="truncate"),
    "corrupt-garbage": dict(corrupt_checkpoint_at_step=2, corrupt_mode="garbage"),
}


@pytest.mark.parametrize("case", sorted(_PLANS))
def test_fault_plan_matches_jax(tmp_path, monkeypatch, case: str) -> None:
    """Both plans on the same calls give the same results, errors,
    observer calls, signals and damaged bytes (one-shot and exact-step
    rules included). The signals are recorded, not sent."""
    kills: list = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(int(sig)))
    results = []
    for plan_cls, cfg_cls in ((jax_faults.FaultPlan, JaxFaultConfig),
                              (port_faults.FaultPlan, PortFaultConfig)):
        kills.clear()
        results.append(_script(case, plan_cls.from_config(cfg_cls(**_PLANS[case])), tmp_path,
                               kills))
    assert results[1] == results[0]


_RB = (jax_elastic.TopologyMismatchError, jax_faults.InjectedFault,
       jax_guard.NonFiniteLossError, jax_spike.RollbackBudgetExceededError)
_RB_PORT = (port_elastic.TopologyMismatchError, port_faults.InjectedFault,
            port_guard.NonFiniteLossError, port_spike.RollbackBudgetExceededError)

_NEW_CHAINS = {
    "bare-RollbackBudgetExceededError": lambda topo, inj, nf, rb: rb("budget"),
    "RuntimeError-from-RollbackBudgetExceededError":
        lambda topo, inj, nf, rb: _raised(_from(RuntimeError("fit"), rb("budget"))),
    "RollbackBudgetExceededError-wrapping-ConnectionError":
        lambda topo, inj, nf, rb: _raised(_from(rb("budget"), ConnectionError("c"))),
    "bare-InjectedFault": lambda topo, inj, nf, rb: inj("injected dataset_load failure 1/2"),
    "RuntimeError-from-InjectedFault":
        lambda topo, inj, nf, rb: _raised(_from(RuntimeError("setup"), inj("i"))),
    "InjectedFault-wrapping-NonFiniteLossError":
        lambda topo, inj, nf, rb: _raised(_from(inj("i"), nf("diverged"))),
    "TopologyMismatchError-over-InjectedFault":
        lambda topo, inj, nf, rb: _raised(_from(topo("mesh"), inj("i"))),
    "RollbackBudgetExceededError-over-TopologyMismatchError":
        lambda topo, inj, nf, rb: _raised(_from(rb("budget"), topo("mesh"))),
}
_NEW_EXPECTED = {
    "bare-RollbackBudgetExceededError": 1, "RuntimeError-from-RollbackBudgetExceededError": 1,
    "RollbackBudgetExceededError-wrapping-ConnectionError": 1, "bare-InjectedFault": 75,
    "RuntimeError-from-InjectedFault": 75, "InjectedFault-wrapping-NonFiniteLossError": 1,
    "TopologyMismatchError-over-InjectedFault": 2,
    "RollbackBudgetExceededError-over-TopologyMismatchError": 2,
}


@pytest.mark.parametrize("chain", sorted(_NEW_CHAINS))
def test_exit_code_of_the_new_classes_equals_jax(chain: str) -> None:
    jax_code = jax_codes.exit_code_for_exception(_NEW_CHAINS[chain](*_RB))
    port_code = port_codes.exit_code_for_exception(_NEW_CHAINS[chain](*_RB_PORT))
    assert port_code == jax_code == _NEW_EXPECTED[chain], (chain, jax_code, port_code)


# ------------------------------------------------------------------ the guard


def _named_params(seed: int) -> list[tuple[str, torch.nn.Parameter]]:
    gen = torch.Generator().manual_seed(seed)
    shapes = {"w": (256, 160), "v": (130, 4), "b": (7,)}  # factored, unfactored, vector
    return [(n, torch.nn.Parameter(torch.randn(s, generator=gen))) for n, s in shapes.items()]


def _state_bits(opt) -> dict:
    params = {f"param/{n}": p.detach().clone() for n, p in zip(opt.names, opt.params)}
    state = {f"state/{i}": t.detach().clone() for i, t in enumerate(opt.state_tensors())}
    return {**params, **state}


@pytest.mark.parametrize("rule", ["adamw", "adafactor", "lion"])
def test_guard_skip_is_bit_identical_and_apply_is_the_plain_update(rule: str) -> None:
    """``step(grads, apply=False)`` leaves the parameters, the moments and
    the EMA bit-identical and the count where it was; ``apply=True`` is
    the unguarded update bit for bit (the guard selects, it does not
    recompute)."""
    cfg = TrainerConfig(max_steps=10, warmup_steps=0, lr=1e-2, weight_decay=0.1,
                        max_grad_norm=0.5, extra={"optimizer": rule, "ema_decay": 0.9})
    guarded = build_optimizer(cfg, _named_params(0))
    plain = build_optimizer(cfg, _named_params(0))
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen) for p in plain.params]
    for opt in (guarded, plain):  # one applied update first: nonzero moments
        opt.step(grads)
    before = _state_bits(guarded)
    poisoned = [g.clone() for g in grads]
    poisoned[1][0, 0] = float("nan")
    guarded.step(poisoned, apply=port_guard.tree_all_finite(poisoned))
    after = _state_bits(guarded)
    assert guarded.count == 1
    assert all(torch.equal(before[k], after[k]) for k in before), rule
    guarded.step(grads, apply=port_guard.tree_all_finite(grads))
    plain.step(grads)
    assert guarded.count == plain.count == 2
    got, want = _state_bits(guarded), _state_bits(plain)
    assert all(torch.equal(got[k], want[k]) for k in want), rule


def test_deterministic_embedding_backward_is_aten_s() -> None:
    """The card's embedding (its backward under deterministic algorithms,
    which aten's CUDA kernel otherwise sums with atomics) gives aten's
    values and gradients, and leaves the global mode as it found it."""
    from llmtrain_tpu_torch.models.gpt import _DeterministicEmbedding

    gen = torch.Generator().manual_seed(3)
    weight = torch.randn(50, 8, generator=gen, requires_grad=True)
    ids = torch.randint(0, 50, (4, 64), generator=gen)  # many repeated rows
    grad = torch.randn(4, 64, 8, generator=gen)
    out = _DeterministicEmbedding.apply(ids, weight)
    out.backward(grad)
    ours, weight.grad = weight.grad, None
    ref = torch.nn.functional.embedding(ids, weight)
    ref.backward(grad)
    assert torch.equal(out, ref) and torch.equal(ours, weight.grad)
    assert not torch.are_deterministic_algorithms_enabled()


def test_guarded_step_reads_the_host_at_most_once(tmp_path) -> None:
    """The repair of the per-tensor host reads: with the guard on, a train
    step makes at most one host read (the previous step's flag, folded
    into the update count), whatever the number of gradient tensors."""
    from torch.overrides import TorchFunctionMode

    reads = {"__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy"}

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in reads:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    raw = _raw(tmp_path, resilience={"nonfinite_guard": True})
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw, "g.yaml"))
    trainer = Trainer(cfg, None)
    ds = trainer._data_module.train_dataset()
    sampler = DeterministicSampler(num_examples=len(ds), batch_size=8, seed=5)
    per_step = []
    for step in range(1, 5):
        batch = trainer.global_batch(sampler, ds, step)
        Count.n = 0
        with Count():
            trainer._train_step_fn(trainer.state, batch)
        per_step.append(Count.n)
    assert len(trainer.state.optimizer.params) > 10
    assert max(per_step) <= 1 and per_step[0] == 0, per_step


# ------------------------------------------------------------------ checkpoints


def test_background_write_error_fails_the_run_promptly(tmp_path) -> None:
    """JAX's ``TestAsyncSaveFailureSurfaces``: with a FILE where the
    checkpoint directory should be, every background write fails, and the
    run stops with that error within a log interval or two, not at
    close()."""
    raw = _raw(tmp_path, resilience={}, max_steps=200, save_every_steps=5,
               log_every_steps=5)
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw, "fail.yaml"))
    run_dir = tmp_path / "async_fail"
    run_dir.mkdir()
    (run_dir / "checkpoints").write_text("not a directory")
    steps: list[int] = []
    trainer = Trainer(cfg, run_dir)
    real = trainer._log_train_interval

    def record(**kw):
        steps.append(kw["step"])
        return real(**kw)

    trainer._log_train_interval = record
    with pytest.raises(OSError):
        trainer.fit()
    assert steps and max(steps) <= 15, steps


def test_async_save_writes_the_state_at_save_time(tmp_path, monkeypatch) -> None:
    """The trainer's host copy is owned: a write still queued while the
    live parameters, moments and EMA change in place (as the next update
    does) commits the values the state had when the save was made."""
    raw = _raw(tmp_path, resilience={}, extra={"ema_decay": 0.9})
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw, "own.yaml"))
    run_dir = tmp_path / "own"
    run_dir.mkdir()
    trainer = Trainer(cfg, run_dir)
    trainer._sampler = DeterministicSampler(num_examples=128, batch_size=8, seed=5)
    expected = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.optimizer
    expected_mu = [m.clone() for m in opt.mu]
    release = threading.Event()
    real_serialize = port_ckpt.msgpack_serialize

    def gated(tree):
        release.wait(30)
        return real_serialize(tree)

    monkeypatch.setattr(port_ckpt, "msgpack_serialize", gated)
    trainer._save_checkpoint(1)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
        for t in [*opt.mu, *opt.ema]:
            t.add_(1.0)
    release.set()
    trainer._ckpt_mgr.close()
    payload = port_ckpt.CheckpointManager.load(run_dir / "checkpoints" / "step_000001.ckpt")
    from llmtrain_tpu_torch.interop import flax_params_to_state_dict

    restored = flax_params_to_state_dict(payload["params"])
    assert all(torch.equal(restored[k].to(v.dtype), v) for k, v in expected.items())
    mu = payload["opt_state"]["mu"]
    assert all(np.array_equal(np.asarray(mu[n]), m.numpy())
               for n, m in zip(opt.names, expected_mu))


def test_resilience_payload_round_trips_between_the_packages(tmp_path) -> None:
    """A checkpoint's ``resilience`` payload written by either package's
    manager (the trainer's keys) restores the same ``rollback_count``,
    ``data_offset`` and detector state through the other's loader and
    detector, and the port trainer's resume reads them from a JAX-written
    payload."""
    det = jax_spike.LossSpikeDetector(factor=4.0, min_history=2)
    for loss in (3.0, 2.5, 2.2, 2.0):
        det.observe(loss)
    payload = {"nonfinite_count": 2, "rollback_count": 1, "data_offset": 6,
               "resume_count": 3, **det.state()}
    host = {"params": {"w": np.arange(4, dtype=np.float32)}, "opt_state": {"count": np.int32(1)}}
    loaded = {}
    for name, writer, reader in (("jax", jax_ckpt.CheckpointManager, port_ckpt.CheckpointManager),
                                 ("port", port_ckpt.CheckpointManager, jax_ckpt.CheckpointManager)):
        path = writer(tmp_path / name).save_host(3, host, {"a": 1}, resilience=payload)
        loaded[name] = reader.load(path)["resilience"]
    for name, det_cls in (("jax", port_spike.LossSpikeDetector),
                          ("port", jax_spike.LossSpikeDetector)):
        resil = loaded[name]
        assert {k: float(v) for k, v in resil.items()} == {k: float(v) for k, v in payload.items()}
        other = det_cls(factor=4.0, min_history=2)
        other.load_state(resil)
        assert other.state() == det.state() and other.trend == det.trend

    # The port trainer's resume applies a JAX-written payload: a port
    # checkpoint whose resilience block is replaced by the one JAX wrote.
    raw = _raw(tmp_path, resilience={"nonfinite_guard": True, "spike_detection": True,
                                     "spike_min_history": 2}, max_steps=4)
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw, "resume.yaml"))
    trainer = Trainer(cfg, None)
    state = trainer.host_state()
    mgr = port_ckpt.CheckpointManager(tmp_path / "mixed")
    ckpt = mgr.save_host(2, state, cfg.model_dump(), resilience=dict(loaded["jax"]))
    resumed = Trainer(cfg, None)
    resumed._restore(str(ckpt), validate_topology=True)
    resil = resumed._last_restored_resilience
    assert int(resil["rollback_count"]) == 1 and int(resil["data_offset"]) == 6
    assert int(resumed.state.nonfinite_count) == 2


# ------------------------------------------------------------------ the slice


def _instants(run_dir: Path) -> list[tuple]:
    keep = []
    for line in (run_dir / "telemetry" / "timeline.jsonl").read_text().splitlines():
        ev = json.loads(line)
        name = ev.get("name", "")
        if ev.get("ph") == "i" and (name in ("rollback", "nonfinite_skip")
                                    or name.startswith("fault_")):
            keep.append((name, ev.get("step"), json.dumps(ev.get("args", {}), sort_keys=True)))
    return keep


def test_guard_and_spike_rollback_track_jax(tmp_path) -> None:
    """The slice: a NaN window at steps 3-4 (guard on) and a 100x spike
    at step 10 (saves every 4, max_rollbacks 1) through both trainers
    from the same params. The same skipped steps and rollback (spike
    step 10, restored step 8, the sampler advanced 2 micro-batches past
    the window), the same instants, losses within the optimizer band."""
    resilience = {"nonfinite_guard": True, "spike_detection": True, "spike_min_history": 2,
                  "max_rollbacks": 1,
                  "faults": {"nan_loss_at_step": 3, "nan_loss_steps": 2,
                             "spike_loss_at_step": 10, "spike_loss_scale": 100.0}}
    raw = _raw(tmp_path, resilience=resilience)
    jax_losses, port_losses, jax_res, port_res = paired_fit(raw, tmp_path, steps=16,
                                                            run_dirs=True)
    assert port_res.rollbacks == jax_res.rollbacks == 1
    assert port_res.final_step == jax_res.final_step == 16
    # Eight logged intervals of two steps: the rolled-back 9-10 is not logged.
    assert len(port_losses) == len(jax_losses) == 16
    nan_at = [i for i, x in enumerate(jax_losses) if not np.isfinite(x)]
    assert nan_at == [i for i, x in enumerate(port_losses) if not np.isfinite(x)] == [2, 3]
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    jax_run, port_run = tmp_path / "jax_run", tmp_path / "port_run"
    assert _instants(port_run) == _instants(jax_run)
    assert ("rollback", 10, json.dumps({"restored_step": 8, "rollback_count": 1},
                                       sort_keys=True)) in _instants(port_run)
    manifests = []
    for run in (jax_run, port_run):
        manifest = jax_ckpt.read_manifest(run / "checkpoints" / "step_000016.ckpt")
        payload = port_ckpt.CheckpointManager.load(run / "checkpoints" / "step_000016.ckpt")
        resil = payload["resilience"]
        manifests.append((manifest["data"]["data_offset"], manifest["data"]["prefetch_generation"],
                          int(resil["rollback_count"]), int(resil["data_offset"])))
    assert manifests[1] == manifests[0] == (2, 1, 1, 2)


def test_exhausted_rollback_budget_exits_1_in_both_clis(tmp_path, capsys) -> None:
    raw = _raw(tmp_path, resilience={"spike_detection": True, "spike_min_history": 2,
                                     "max_rollbacks": 0,
                                     "faults": {"spike_loss_at_step": 6,
                                                "spike_loss_scale": 100.0}},
               max_steps=8, micro_batch_size=8)
    raw["telemetry"] = {"enabled": False}
    cfg = _write(tmp_path, raw, "budget.yaml")
    for main, run_id in ((jax_main, "jax"), (port_main, "port")):
        assert run_cli(main, ["train", "--config", str(cfg), "--run-id", run_id]) == 1
        assert "exhausting the rollback budget" in capsys.readouterr().err


def test_consensus_rollback_over_two_gloo_processes(tmp_path) -> None:
    """JAX's multi-process rollback path with two real ranks: the spike
    step agreed by all-gather, rank 0's target broadcast, every rank
    restoring it, and the run completing with one rollback."""
    from test_torch_ddp import _raw as ddp_raw

    raw = ddp_raw(tmp_path, max_steps=12, log_every_steps=2, eval_every_steps=12,
                  save_every_steps=4)
    raw["resilience"] = {"spike_detection": True, "spike_min_history": 2, "max_rollbacks": 2,
                         "faults": {"spike_loss_at_step": 8, "spike_loss_scale": 100.0}}
    cfg = _write(tmp_path, raw, "consensus.yaml")
    outs = wait(launch(tmp_path, ["train", "--config", str(cfg), "--run-id", "c", "--json"]))
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-3000:]
    result = json.loads(_summary_lines(outs[0][1])[-1])["train_result"]
    assert result["rollbacks"] == 1 and result["final_step"] == 12
    for _, _, err in outs:
        assert "rolled back to checkpoint step 4" in err

