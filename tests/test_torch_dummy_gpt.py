"""The port's ``dummy_gpt`` against the JAX package's, on the CPU.

Logits through the carry-over (atol/rtol 2e-5, the logits band), the
carry-over both ways, the adapter's clamps, a ``dummy_smoke`` run whose
per-step losses track JAX's from the same initial params within the
optimizer-trajectory band (atol 3e-5, rtol 1e-3), and checkpoints of the
dummy model that each package's reader takes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import REPO_ROOT, paired_fit, random_params, seeded_ids, to_torch

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.models.dummy_gpt import DummyGPTAdapter as JaxDummyAdapter
from llmtrain_tpu.models.dummy_gpt import _TinyLM
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.interop.flax_params import (
    flax_dummy_gpt_params_to_state_dict,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from llmtrain_tpu_torch.models.dummy_gpt import DummyGPTAdapter, TinyLM

LOGITS_TOL = 2e-5
TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3


def _jax_tiny(vocab: int, d: int, seed: int):
    module = _TinyLM(vocab_size=vocab, d_model=d)
    return module, random_params(module, jnp.zeros((1, 8), jnp.int32), seed=seed)


@pytest.mark.parametrize("vocab, d", [(32, 64), (128, 16), (61, 40)])
def test_logits_match_jax(vocab: int, d: int) -> None:
    module, params = _jax_tiny(vocab, d, seed=vocab)
    ids = seeded_ids(d, (3, 8), vocab)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    model = TinyLM(vocab, d)
    model.load_state_dict(flax_dummy_gpt_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(to_torch(ids)).numpy()
    assert got.shape == (3, 8, vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_carry_over_round_trips_and_dispatches() -> None:
    _, params = _jax_tiny(32, 16, seed=3)
    sd = flax_params_to_state_dict(params)
    assert set(sd) == set(TinyLM(32, 16).state_dict())
    back = state_dict_to_flax_params(sd, n_heads=2)
    flat = serialization.to_state_dict(params)
    for name, leaves in flat.items():
        for key, leaf in leaves.items():
            np.testing.assert_array_equal(back[name][key].numpy(), np.asarray(leaf), f"{name}.{key}")


@pytest.mark.parametrize(
    "model",
    [{"d_model": 128, "vocab_size": None}, {"d_model": 16, "vocab_size": 40},
     {"d_model": 64, "vocab_size": 32}],
    ids=["clamped", "small", "dummy_smoke"],
)
def test_adapter_clamps_as_jax(model) -> None:
    raw = {"run": {"name": "d", "device": "cpu"},
           "model": {"name": "dummy_gpt", "block_size": 8, "n_layers": 1, "n_heads": 2,
                     "d_ff": 128, **model},
           "data": {"name": "dummy_text"}, "trainer": {"max_steps": 2, "warmup_steps": 0}}
    ours = DummyGPTAdapter().build_model(RunConfig.model_validate(raw))
    theirs = JaxDummyAdapter().build_model(JaxRunConfig.model_validate(raw))
    assert (ours.vocab_size, ours.d_model) == (theirs.vocab_size, theirs.d_model)
    assert DummyGPTAdapter().build_tokenizer(RunConfig.model_validate(raw)) is None
    # flax's initializers: embedding N(0, 1/d), kernels LeCun truncated normal.
    assert torch.all(ours.mlp_in.weight.abs() <= 2 / 0.8796 / ours.d_model**0.5 + 1e-6)
    assert torch.all(ours.mlp_in.bias == 0) and torch.all(ours.ln_f.weight == 1)


def _dummy_smoke(tmp_path, **trainer) -> dict:
    """dummy_smoke.yaml with a global micro-batch of 8 (JAX's 8 test
    devices take one row each), every step logged. dummy_text sizes its
    data by max_steps x micro_batch_size, capped at 128 examples, so
    max_steps 128 gives both configs the capped set; the runs stop early."""
    raw = yaml.safe_load((REPO_ROOT / "configs/presets/dummy_smoke.yaml").read_text())
    raw["trainer"].update(max_steps=128, micro_batch_size=8, log_every_steps=1,
                          eval_every_steps=3, save_every_steps=3, **trainer)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    return raw


def _written(tmp_path, raw: dict) -> str:
    path = tmp_path / "dummy_smoke.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


@pytest.mark.parametrize("trainer", [{}, {"weight_decay": 0.1, "warmup_steps": 2}],
                         ids=["preset", "decay-warmup"])
def test_dummy_smoke_losses_track_jax(tmp_path, trainer) -> None:
    jax_losses, port_losses, jax_result, port_result = paired_fit(
        _dummy_smoke(tmp_path, **trainer), tmp_path, steps=6)
    assert len(port_losses) == len(jax_losses) == 6
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    assert port_losses[-1] < port_losses[0]
    np.testing.assert_allclose(port_result.final_val_loss, jax_result.final_val_loss,
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    assert port_result.parameter_count == jax_result.parameter_count


def test_dummy_checkpoint_is_read_by_jax_and_resumes(tmp_path, capsys) -> None:
    from torch_port_helpers import run_cli

    from llmtrain_tpu.training.checkpoint import load_inference_params as jax_load_params
    from llmtrain_tpu_torch.cli import main as port_main

    raw = _dummy_smoke(tmp_path)
    raw["trainer"]["max_steps"] = 6
    cfg = _written(tmp_path, raw)
    assert run_cli(port_main, ["train", "--config", cfg, "--run-id", "d", "--json"]) == 0
    ckpt = tmp_path / "runs" / "d" / "checkpoints" / "step_000006.ckpt"
    module = _TinyLM(vocab_size=32, d_model=64)
    abstract = serialization.to_state_dict(random_params(module, jnp.zeros((1, 8), jnp.int32)))
    params, step = jax_load_params(ckpt, abstract, device=False)
    assert step == 6
    model = TinyLM(32, 64)
    from llmtrain_tpu_torch.training.checkpoint import load_inference_params

    assert load_inference_params(ckpt, model) == 6
    for name, tensor in flax_params_to_state_dict(params).items():
        torch.testing.assert_close(model.state_dict()[name], tensor, rtol=0, atol=0)
    mid = tmp_path / "runs" / "d" / "checkpoints" / "step_000003.ckpt"
    assert run_cli(port_main, ["train", "--config", cfg, "--run-id", "r", "--resume", str(mid),
                               "--json"]) == 0
    capsys.readouterr()
