"""The port's Adafactor, Lion and parameter EMA against optax as the JAX
package builds them (``llmtrain_tpu/training/optimizer.py``), on the CPU.

Band: the optimizer trajectory's, atol 3e-5 and rtol 1e-3 (ROADMAP.md).
Shapes cover both of Adafactor's moments: matrices whose second-largest
dim is >= 128 (factored, 2-D and 4-D), smaller ones and vectors (a full
second moment). Also: the EMA's f32 shadow under bf16 parameters, the
invalid decays, ``paired_fit`` trajectories of the trainer, each
optimizer's checkpoint round trip and exact resume, ``eval --ema``,
``generate --ema`` and ``export-checkpoint --ema`` against JAX's CLI on the
same checkpoint, the backoff retry's delays and the dataset-setup retry,
and the step profiler.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch_port_helpers import REPO_ROOT, paired_fit, run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.config.schemas import TrainerConfig as JaxTrainerConfig
from llmtrain_tpu.resilience.faults import retry as jax_retry
from llmtrain_tpu.resilience.faults import retry_rng as jax_retry_rng
from llmtrain_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from llmtrain_tpu.training.optimizer import find_ema_tree as jax_find_ema_tree
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.config.schemas import TrainerConfig
from llmtrain_tpu_torch.resilience.faults import retry, retry_rng
from llmtrain_tpu_torch.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch.training.optimizer import (
    EMA_STATE_KEY,
    build_optimizer,
    factored_dims,
    find_ema_tree,
)

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
STEPS = 20
SHAPES = {
    "factored": (160, 192),
    "factored_4d": (130, 3, 2, 140),
    "unfactored": (64, 300),
    "vector": (300,),
}
BASE = dict(max_steps=STEPS, lr=3e-2, warmup_steps=3, max_grad_norm=5.0)


def _trajectories(extra: dict, weight_decay: float, dtype=np.float32):
    """20 steps of the port's optimizer and optax's on the same seeded
    params and gradients (every fourth step's gradients large enough to
    clip): (port params, JAX params, port EMA shadow or None, JAX state)
    per step, and the port's optimizer."""
    rng = np.random.default_rng(3)
    init = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}
    trainer = dict(BASE, weight_decay=weight_decay, extra=extra)
    tx = jax_build_optimizer(JaxTrainerConfig(**trainer))
    j_params = {k: jnp.asarray(v, dtype) for k, v in init.items()}
    j_state = tx.init(j_params)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))) for k, v in init.items()]
    opt = build_optimizer(TrainerConfig(**trainer), named)
    out = []
    for step in range(STEPS):
        scale = 4.0 if step % 4 == 3 else 0.3
        grads = {k: (rng.normal(0, scale, s) + 0.1).astype(np.float32) for k, s in SHAPES.items()}
        updates, j_state = tx.update({k: jnp.asarray(v, dtype) for k, v in grads.items()},
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step([torch.from_numpy(grads[k]).to(p.dtype) for k, p in named])
        shadow = None if opt.ema is None else {
            n: e.numpy().copy() for n, e in zip(opt.names, opt.ema)}
        out.append(({k: p.detach().float().numpy().copy() for k, p in named},
                    {k: np.asarray(v, np.float32) for k, v in j_params.items()}, shadow, j_state))
    return out, opt


@pytest.mark.parametrize(
    "extra,weight_decay",
    [({"optimizer": "adafactor"}, 0.0), ({"optimizer": "adafactor"}, 0.1),
     ({"optimizer": "lion"}, 0.0), ({"optimizer": "lion"}, 0.1)],
    ids=["adafactor", "adafactor-decay", "lion", "lion-decay"],
)
def test_trajectory_matches_optax(extra, weight_decay) -> None:
    for step, (ours, theirs, _, _) in enumerate(_trajectories(extra, weight_decay)[0]):
        for k in SHAPES:
            np.testing.assert_allclose(ours[k], theirs[k], atol=TRAJ_ATOL, rtol=TRAJ_RTOL,
                                       err_msg=f"{k} after step {step + 1}")


def test_adafactor_factors_as_optax() -> None:
    """The factoring rule and the moments' shapes are optax's."""
    steps, opt = _trajectories({"optimizer": "adafactor"}, 0.0)
    j_state = steps[-1][3]
    factored = next(x for x in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(x, "v_row"))
    for i, name in enumerate(opt.names):
        shape = SHAPES[name]
        if name.startswith("factored"):
            assert factored_dims(shape) is not None
            np.testing.assert_allclose(opt.v_row[i].numpy(), np.asarray(factored.v_row[name]),
                                       rtol=1e-4, atol=1e-12)
            np.testing.assert_allclose(opt.v_col[i].numpy(), np.asarray(factored.v_col[name]),
                                       rtol=1e-4, atol=1e-12)
        else:
            assert factored_dims(shape) is None
            np.testing.assert_allclose(opt.v[i].numpy(), np.asarray(factored.v[name]),
                                       rtol=1e-4, atol=1e-12)
    # The state is the factored moments, far below AdamW's two full ones.
    params = sum(int(np.prod(s)) for s in SHAPES.values())
    state = opt.state_dict()
    stored = sum(a.nbytes for key in ("v_row", "v_col", "v") for a in state[key].values())
    assert set(state["v_row"]) == {"factored", "factored_4d"} and stored < 0.7 * 2 * params * 4


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "lion"])
def test_ema_recurrence_matches_optax(optimizer) -> None:
    steps, _ = _trajectories({"optimizer": optimizer, "ema_decay": 0.9}, 0.1)
    for step, (_, _, ours, j_state) in enumerate(steps):
        theirs = jax_find_ema_tree(j_state)
        for name in SHAPES:
            np.testing.assert_allclose(ours[name], np.asarray(theirs[name]), atol=TRAJ_ATOL,
                                       rtol=TRAJ_RTOL, err_msg=f"{name} after step {step + 1}")


def test_ema_shadow_is_f32_under_bf16_params() -> None:
    """JAX's tests/test_ema.py: a (1 - d) step is below bf16's resolution,
    so a bf16 shadow would stay pinned at its init (the bf16 params move
    by ~lr a step, the shadow by 1e-3 of that)."""
    cfg = TrainerConfig(max_steps=100, lr=1e-2, warmup_steps=0, weight_decay=0.0,
                        extra={"ema_decay": 0.999})
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = build_optimizer(cfg, [("w", p)])
    assert opt.ema[0].dtype == torch.float32
    for _ in range(20):
        opt.step([torch.full((4,), 1e-3, dtype=torch.bfloat16)])
    assert float((opt.ema[0] - 1.0).abs().max()) > 1e-4
    assert opt.state_dict()[EMA_STATE_KEY]["w"].dtype == np.float32


@pytest.mark.parametrize("decay", [0, 1.0, -0.5, 1.5])
def test_invalid_ema_decay_raises_as_jax(decay) -> None:
    cfg = dict(max_steps=4, warmup_steps=0, extra={"ema_decay": decay})
    with pytest.raises(ValueError) as theirs:
        jax_build_optimizer(JaxTrainerConfig(**cfg))
    with pytest.raises(ValueError) as ours:
        build_optimizer(TrainerConfig(**cfg), [])
    assert str(ours.value) == str(theirs.value)


def _gpt_raw(tmp_path: Path, **extra) -> dict:
    """A one-layer GPT wide enough for Adafactor to factor its embeddings
    and MLP (d_model 128, d_ff 256, vocab 130) on dummy_text, every step
    logged; max_steps 128 gives JAX's per-device micro batch of 1 the same
    capped 128 examples (the runs stop early)."""
    return {
        "schema_version": 1,
        "run": {"name": "opt", "seed": 5, "device": "cpu", "deterministic": True},
        "model": {"name": "gpt", "block_size": 8, "d_model": 128, "n_layers": 1, "n_heads": 2,
                  "d_ff": 256, "dropout": 0.0, "vocab_size": 130, "attention": "dense"},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 128, "micro_batch_size": 8, "lr": 3e-3, "warmup_steps": 2,
                    "weight_decay": 0.1, "log_every_steps": 1, "eval_every_steps": 3,
                    "save_every_steps": 3, "extra": extra},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": True},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


@pytest.mark.parametrize(
    "extra",
    [{"optimizer": "adafactor"}, {"optimizer": "lion"}, {"ema_decay": 0.9}],
    ids=["adafactor", "lion", "ema"],
)
def test_paired_fit_matches_jax(tmp_path, extra) -> None:
    jax_losses, port_losses, jax_result, port_result = paired_fit(
        _gpt_raw(tmp_path, **extra), tmp_path, steps=6)
    assert len(port_losses) == len(jax_losses) == 6
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(port_result.final_val_loss, jax_result.final_val_loss,
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)


def _write(tmp_path: Path, raw: dict, name: str = "opt.yaml") -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


@pytest.mark.parametrize(
    "extra",
    [{"optimizer": "adafactor"}, {"optimizer": "lion"}, {"ema_decay": 0.9}],
    ids=["adafactor", "lion", "adamw-ema"],
)
def test_checkpoint_round_trip_and_exact_resume(tmp_path, capsys, extra) -> None:
    raw = _gpt_raw(tmp_path, **extra)
    raw["trainer"].update(max_steps=6, log_every_steps=2, eval_every_steps=6, save_every_steps=3)
    cfg = _write(tmp_path, raw)
    assert run_cli(port_main, ["train", "--config", cfg, "--run-id", "whole", "--json"]) == 0
    whole = json.loads(capsys.readouterr().out)["train_result"]
    ckpts = tmp_path / "runs" / "whole" / "checkpoints"
    opt_state = CheckpointManager.load(ckpts / "step_000003.ckpt")["opt_state"]
    keys = {"adafactor": {"count", "v_row", "v_col", "v"}, "lion": {"count", "mu"}}.get(
        extra.get("optimizer"), {"count", "mu", "nu", EMA_STATE_KEY})
    assert set(opt_state) == keys and int(opt_state["count"]) == 3
    assert run_cli(port_main, ["train", "--config", cfg, "--run-id", "resumed", "--resume",
                               str(ckpts / "step_000003.ckpt"), "--json"]) == 0
    resumed = json.loads(capsys.readouterr().out)["train_result"]
    assert resumed["resumed_from_step"] == 3
    assert resumed["final_loss"] == whole["final_loss"]
    assert resumed["final_val_loss"] == whole["final_val_loss"]
    # The resumed run's checkpoint carries the same optimizer state.
    again = CheckpointManager.load(tmp_path / "runs" / "resumed" / "checkpoints"
                                   / "step_000006.ckpt")["opt_state"]
    first = CheckpointManager.load(ckpts / "step_000006.ckpt")["opt_state"]

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix, np.asarray(tree)

    for (ka, a), (kb, b) in zip(leaves(first), leaves(again), strict=True):
        assert ka == kb
        np.testing.assert_array_equal(a, b, err_msg=str(ka))


@pytest.fixture(scope="module")
def ema_trained(tmp_path_factory) -> dict:
    """A port checkpoint of a run with the EMA (decay 0.5, so the shadow
    is far from both the init and the params)."""
    root = tmp_path_factory.mktemp("ema")
    raw = _gpt_raw(root, ema_decay=0.5)
    raw["model"].update(d_model=32, d_ff=64, vocab_size=40)
    raw["trainer"].update(max_steps=4, log_every_steps=2, eval_every_steps=4, save_every_steps=4,
                          micro_batch_size=8)
    cfg = _write(root, raw, "ema.yaml")
    assert run_cli(port_main, ["train", "--config", cfg, "--run-id", "e", "--json"]) == 0
    plain = dict(raw, trainer={**raw["trainer"], "extra": {}})
    plain_cfg = _write(root, plain, "plain.yaml")
    assert run_cli(port_main, ["train", "--config", plain_cfg, "--run-id", "p", "--json"]) == 0
    return {"root": root, "cfg": cfg, "plain_cfg": plain_cfg,
            "ckpt": root / "runs" / "e" / "checkpoints" / "step_000004.ckpt",
            "plain": root / "runs" / "p" / "checkpoints" / "step_000004.ckpt"}


def _json_out(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_ema_matches_the_shadow_and_jax(ema_trained, capsys) -> None:
    """``eval --ema`` evaluates the shadow: the same loss as JAX's ``eval``
    of the shadow exported by JAX's ``export-checkpoint --ema`` and
    imported back (JAX's own ``eval`` restores the optimizer state, which
    each package keeps in its own layout), and not the raw eval."""
    cfg, ckpt = ema_trained["cfg"], str(ema_trained["ckpt"])
    assert run_cli(port_main, ["eval", "--config", cfg, "--from", ckpt, "--json"]) == 0
    raw = _json_out(capsys)["metrics"]["val/loss"]
    assert run_cli(port_main, ["eval", "--config", cfg, "--from", ckpt, "--ema", "--json"]) == 0
    ema = _json_out(capsys)["metrics"]["val/loss"]
    exported = ema_trained["root"] / "jax_ema.pt"
    assert run_cli(jax_main, ["export-checkpoint", "--config", cfg, "--from", ckpt, "--ema",
                              "--output", str(exported)]) == 0
    imported = ema_trained["root"] / "jax_ema_imported"
    assert run_cli(jax_main, ["import-checkpoint", "--config", ema_trained["plain_cfg"],
                              "--input", str(exported), "--output", str(imported)]) == 0
    capsys.readouterr()
    assert run_cli(jax_main, ["eval", "--config", ema_trained["plain_cfg"], "--from",
                              str(imported), "--json"]) == 0
    theirs = _json_out(capsys)["metrics"]["val/loss"]
    assert ema != raw
    np.testing.assert_allclose(ema, theirs, atol=2e-5, rtol=2e-5)


def test_export_ema_equals_jax(ema_trained, capsys) -> None:
    cfg, ckpt = ema_trained["cfg"], str(ema_trained["ckpt"])
    out = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        path = ema_trained["root"] / f"export_{name}.pt"
        assert run_cli(main, ["export-checkpoint", "--config", cfg, "--from", ckpt, "--ema",
                              "--output", str(path), "--json"]) == 0
        capsys.readouterr()
        out[name] = torch.load(path)
    assert out["port"].keys() == out["jax"].keys()
    for k in out["port"]:
        torch.testing.assert_close(out["port"][k], out["jax"][k], rtol=0, atol=0, msg=k)
    raw = torch.load(ema_trained["root"] / "export_port.pt")
    assert run_cli(port_main, ["export-checkpoint", "--config", cfg, "--from", ckpt,
                               "--output", str(ema_trained["root"] / "raw.pt")]) == 0
    assert not torch.equal(torch.load(ema_trained["root"] / "raw.pt")["lm_head.weight"],
                           raw["lm_head.weight"])


def test_generate_ema_equals_jax(ema_trained, capsys) -> None:
    cfg, ckpt = ema_trained["cfg"], str(ema_trained["ckpt"])
    argv = ["generate", "--config", cfg, "--from", ckpt, "--ema", "--prompt-ids", "3,1,4,1,5",
            "--max-new-tokens", "3", "--temperature", "0", "--logprobs", "--json"]
    assert run_cli(jax_main, argv) == 0
    theirs = _json_out(capsys)
    assert run_cli(port_main, argv) == 0
    ours = _json_out(capsys)
    assert ours["output_ids"] == theirs["output_ids"]
    np.testing.assert_allclose(ours["logprobs"], theirs["logprobs"], atol=2e-5, rtol=0)


def test_ema_without_a_shadow_answers_as_jax(ema_trained, capsys) -> None:
    answers = []
    for main in (jax_main, port_main):
        code = run_cli(main, ["export-checkpoint", "--config", ema_trained["plain_cfg"],
                              "--from", str(ema_trained["plain"]), "--ema", "--output",
                              str(ema_trained["root"] / "none.pt")])
        answers.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])))
    assert answers[0] == answers[1] and answers[0][0] != 0, answers
    assert "holds no EMA state" in answers[0][1]["error"]


def test_live_ema_evaluates_on_a_copy(tmp_path) -> None:
    """``Trainer.evaluate(use_ema=True)`` without a checkpoint evaluates
    the live shadow on a copy: the trainer's own model is untouched."""
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _gpt_raw(tmp_path, ema_decay=0.5)
    raw["model"].update(d_model=32, d_ff=64, vocab_size=40)
    raw["trainer"].update(max_steps=3, eval_every_steps=3, save_every_steps=3)
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw))
    trainer = Trainer(cfg, None)
    result = trainer.fit()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ema = trainer.evaluate(use_ema=True)["val/loss"]
    assert ema != result.final_val_loss
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer.evaluate()["val/loss"] == result.final_val_loss
    raw["trainer"]["extra"] = {}
    no_ema = Trainer(load_and_validate_config(_write(tmp_path, raw, "plain.yaml"))[0], None)
    with pytest.raises(ValueError, match="no EMA state in the optimizer"):
        no_ema.evaluate(use_ema=True)


def test_find_ema_tree_reads_both_layouts() -> None:
    assert find_ema_tree({"count": 1, EMA_STATE_KEY: {"a": 1}}) == {"a": 1}
    assert find_ema_tree({"0": {"count": 1}, "1": [{EMA_STATE_KEY: 2}]}) == 2
    assert find_ema_tree({"count": 1, "mu": {}}) is None


@pytest.mark.parametrize("seed,rank", [(0, 0), (1337, 1), (7, 3)])
def test_retry_delays_match_jax(seed, rank) -> None:
    def delays(fn, rng) -> list[float]:
        slept: list[float] = []

        def failing():
            raise ConnectionError("down")

        with pytest.raises(ConnectionError):
            fn(failing, attempts=5, base_delay=0.05, max_delay=0.3, sleep=slept.append, rng=rng)
        return slept

    ours = delays(retry, retry_rng(seed, rank))
    assert ours == delays(jax_retry, jax_retry_rng(seed, rank))
    assert len(ours) == 4 and all(0 <= d <= 0.3 for d in ours)
    assert retry_rng(seed, rank).random() != retry_rng(seed, rank + 1).random()
    assert isinstance(retry_rng(seed), random.Random)


def test_dataset_setup_retries(tmp_path, monkeypatch) -> None:
    """A data module whose setup raises ConnectionError twice builds on
    the third attempt (resilience.retry_attempts 3); one more failure
    reaches the caller."""
    from llmtrain_tpu_torch.data.dummy_text import DummyTextDataModule
    from llmtrain_tpu_torch.training.trainer import Trainer

    real = DummyTextDataModule.setup
    calls = {"n": 0, "fail": 2}

    def flaky(self, cfg, tokenizer=None):
        calls["n"] += 1
        if calls["n"] <= calls["fail"]:
            raise ConnectionError("dataset host unreachable")
        return real(self, cfg, tokenizer)

    monkeypatch.setattr(DummyTextDataModule, "setup", flaky)
    raw = _gpt_raw(tmp_path)
    raw["resilience"] = {"retry_base_delay": 0.0}
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw))
    Trainer(cfg, None)
    assert calls["n"] == 3
    calls.update(n=0, fail=3)
    with pytest.raises(ConnectionError):
        Trainer(cfg, None)


def test_step_profiler_writes_a_trace_and_survives_failure(tmp_path, monkeypatch) -> None:
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _gpt_raw(tmp_path, profile_start_step=2, profile_num_steps=2)
    raw["model"].update(d_model=32, d_ff=64, vocab_size=40)
    raw["trainer"].update(max_steps=4, eval_every_steps=4, save_every_steps=4)
    cfg, _, _ = load_and_validate_config(_write(tmp_path, raw))
    run_dir = tmp_path / "run"
    (run_dir / "logs").mkdir(parents=True)
    clean = Trainer(cfg, run_dir).fit()
    traces = list((run_dir / "logs" / "profile").glob("*.json"))
    assert [t.name for t in traces] == ["steps_2-3.pt.trace.json"]
    assert json.loads(traces[0].read_text())["traceEvents"]

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    run_dir = tmp_path / "broken"
    (run_dir / "logs").mkdir(parents=True)
    result = Trainer(cfg, run_dir).fit()
    assert result.final_step == 4 and result.final_loss == clean.final_loss
    assert not (run_dir / "logs" / "profile").exists() or not list(
        (run_dir / "logs" / "profile").glob("*.json"))
