"""The port's LoRA against the JAX package's, on the CPU.

* ``LoraSpec.from_extra``: the same spec, and JAX's message for every
  malformed one; a malformed spec exits 2 in both CLIs;
* the factor tree: a LoRA model's factors have JAX ``init_lora``'s paths
  and shapes for the fused, GQA and llama trees; its merged weights equal
  JAX's ``merge_lora`` of the same arrays;
* the loss and the factors' gradients of a ``{base, lora}`` tree carried
  over from JAX within atol 1e-5, rtol 1e-4; the base takes no gradient;
* training: the base bit-identical after the steps (no gradient, no
  optimizer state, no decay), the per-step losses within the trajectory
  band (atol 3e-5, rtol 1e-3) of JAX's trainer from its initial params,
  the checkpoint in JAX's ``{base, lora}`` layout;
* ``export-checkpoint`` merges: bit for bit the state dict JAX's CLI
  exports from the same checkpoint, with and without ``--ema``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import REPO_ROOT, paired_fit, random_params, run_cli, seeded_ids, to_torch

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.models import lora as jax_lora
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.interop.flax_params import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from llmtrain_tpu_torch.models import lora

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
VOCAB = 53


def _raw(name: str = "gpt", spec: dict | None = None, **extra) -> dict:
    return {
        "run": {"name": "lora", "device": "cpu", "seed": 6},
        "model": {"name": name, "block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 4,
                  "d_ff": 64, "dropout": 0.0, "vocab_size": VOCAB,
                  "extra": {"lora": spec or {"rank": 4, "alpha": 8}, **extra}},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 2, "warmup_steps": 0},
    }


@pytest.mark.parametrize("spec", [
    3, {"rank": 4, "dropout": 0.1}, {"rank": 0}, {"rank": 2, "alpha": -1.0},
    {"targets": "qkv_proj"}, {"targets": []},
], ids=["not-a-mapping", "unknown-key", "rank", "alpha", "string-targets", "no-targets"])
def test_malformed_specs_raise_jax_messages(spec) -> None:
    with pytest.raises(ValueError) as theirs:
        jax_lora.LoraSpec.from_extra({"lora": spec})
    with pytest.raises(ValueError) as ours:
        lora.LoraSpec.from_extra({"lora": spec})
    assert str(ours.value) == str(theirs.value)


def test_spec_defaults_match_jax() -> None:
    for raw in ({"rank": 4}, {"rank": 8, "alpha": 16, "targets": ["mlp_fc", "out_proj"]}):
        theirs = jax_lora.LoraSpec.from_extra({"lora": raw})
        ours = lora.LoraSpec.from_extra({"lora": raw})
        assert (ours.rank, ours.alpha, ours.targets, ours.scale) == (
            theirs.rank, theirs.alpha, theirs.targets, theirs.scale)
    assert lora.LoraSpec.from_extra({}) is None


def test_malformed_spec_exit_codes_match_jax(tmp_path, capsys) -> None:
    """``validate``, ``train``, ``eval`` and ``export-checkpoint`` refuse a
    malformed spec as a config error (2) before building anything."""
    from llmtrain_tpu.cli import main as jax_main

    raw = yaml.safe_load((REPO_ROOT / "configs/presets/gpt_smoke.yaml").read_text())
    raw["model"]["extra"] = {"lora": {"rank": 0}}
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "bad_lora.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    for command, code in ((["validate", "--config", str(cfg)], 2),
                          (["eval", "--config", str(cfg), "--from", str(tmp_path)], 2),
                          (["export-checkpoint", "--config", str(cfg), "--from", str(tmp_path),
                            "--output", str(tmp_path / "x.pt")], 2),
                          (["train", "--config", str(cfg), "--run-id", "r"], 2)):
        run_id = ["--run-id", "j"] if command[0] == "train" else []
        jax_cmd = command[:-2] + run_id if run_id else command
        assert run_cli(jax_main, jax_cmd) == code, jax_cmd
        assert run_cli(port_main, command) == code, command
    assert "lora.rank must be >= 1" in capsys.readouterr().err


def _jax_pair(name: str, spec: dict | None = None, **extra):
    """A JAX model with seeded {base, lora} params (B nonzero so the delta
    shows), and the port's LoraModel carrying the same tree."""
    from llmtrain_tpu.registry import initialize_registries

    initialize_registries()
    raw = _raw(name, spec, **extra)
    adapter = jax_lora.build_adapter(JaxRunConfig.model_validate(raw))
    jm = adapter.build_model(JaxRunConfig.model_validate(raw))
    base = random_params(jm, jnp.zeros((1, 16), jnp.int32), seed=7)
    factors = jax.tree.map(np.asarray, jax_lora.init_lora(base, adapter.spec, jax.random.key(1)))
    rng = np.random.default_rng(8)
    factors = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.normal(0, 0.1, x.shape).astype(np.float32)
        if getattr(p[-1], "key", None) == "b" else x, factors)
    params = {"base": serialization.to_state_dict(base), "lora": factors}
    port_adapter = lora.build_adapter(RunConfig.model_validate(raw))
    model = port_adapter.build_model(RunConfig.model_validate(raw))
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return adapter, jm, params, port_adapter, model


CASES = {"gpt-fused": ("gpt", None, {}),
         "gpt-gqa-mlp": ("gpt", {"rank": 3, "targets": ["q_proj", "kv_proj", "mlp_fc",
                                                        "token_embedding"]}, {"n_kv_heads": 2}),
         "llama": ("llama", {"rank": 4, "alpha": 4, "targets": ["q_proj", "out_proj", "mlp_up",
                                                                "lm_head"]},
                   {"n_kv_heads": 2})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_factors_merge_loss_and_grads_match_jax(case: str) -> None:
    name, spec, extra = CASES[case]
    adapter, jm, params, port_adapter, model = _jax_pair(name, spec, **extra)
    # The factor tree: JAX's paths and shapes, and the port's own init too.
    fresh = port_adapter.build_model(RunConfig.model_validate(_raw(name, spec, **extra)))
    mine = state_dict_to_flax_params(fresh.state_dict(), n_heads=4,
                                     n_kv_heads=extra.get("n_kv_heads", 0))["lora"]
    shapes = jax.tree.map(np.shape, params["lora"])
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert all(not np.asarray(v).any() for p, v in jax.tree_util.tree_leaves_with_path(mine)
               if p[-1].key == "b")
    # The merged weights against JAX's merge_lora of the same arrays.
    theirs = jax_lora.to_inference_params(adapter, params)
    with torch.no_grad():
        merged = {**{n: p for n, p in model.base.named_parameters()}, **model.merged_weights()}
    ours = state_dict_to_flax_params(merged, n_heads=4, n_kv_heads=extra.get("n_kv_heads", 0))
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    for path, leaf in jax.tree_util.tree_leaves_with_path(theirs):
        np.testing.assert_allclose(flat[path].numpy(), np.asarray(leaf), atol=1e-7, rtol=1e-6)
    # Loss and gradients.
    ids = seeded_ids(9, (3, 17), VOCAB)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: adapter.compute_loss(jm, p, jbatch), has_aux=True)(params)
    loss, _ = port_adapter.compute_loss(model, {k: to_torch(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-5 * (1 + abs(float(jloss)))
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    for pname, p in model.named_parameters():
        if pname.startswith("base."):
            assert p.grad is None and not p.requires_grad, pname
            assert not np.asarray(want[pname]).any(), pname  # JAX: stop_gradient
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=pname)


def _lora_smoke(tmp_path, **trainer) -> dict:
    raw = yaml.safe_load((REPO_ROOT / "configs/presets/gpt_smoke.yaml").read_text())
    raw["model"].update(block_size=16, n_heads=4)
    raw["model"]["extra"] = {"lora": {"rank": 4, "alpha": 8, "targets": ["qkv_proj", "mlp_fc"]}}
    raw["trainer"].update(max_steps=128, micro_batch_size=8, lr=0.01, log_every_steps=1,
                          eval_every_steps=100, save_every_steps=4, **trainer)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    return raw


def test_training_freezes_the_base_and_tracks_jax(tmp_path) -> None:
    """Weight decay on: the base must still come out bit for bit."""
    raw = _lora_smoke(tmp_path, weight_decay=0.1)
    jax_losses, port_losses, _, port_result = paired_fit(raw, tmp_path, steps=4, run_dirs=True)
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    assert port_result.trainable_parameter_count < port_result.parameter_count
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    ckpts = sorted((tmp_path / "port_run" / "checkpoints").glob("step_*.ckpt"))
    payload = CheckpointManager.load(ckpts[-1])
    assert set(payload["params"]) == {"base", "lora"}
    # The state the optimizer keeps is the factors' only.
    names = set(payload["opt_state"]["mu"])
    assert names and all(n.startswith("lora.") for n in names)


def test_base_is_bit_identical_after_fit(tmp_path) -> None:
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _lora_smoke(tmp_path, weight_decay=0.1)
    raw["trainer"]["max_steps"] = 3
    path = tmp_path / "lora.yaml"
    path.write_text(yaml.safe_dump(raw))
    from llmtrain_tpu_torch.config import load_and_validate_config

    trainer = Trainer(load_and_validate_config(path)[0], None)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.fit()
    for n, p in trainer.model.named_parameters():
        if n.startswith("base."):
            assert torch.equal(p, before[n]), n
        elif n.endswith("/b"):
            assert not torch.equal(p, before[n]), n


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
def test_export_merges_as_jax(tmp_path, ema: bool) -> None:
    from llmtrain_tpu.cli import main as jax_main

    raw = _lora_smoke(tmp_path)
    raw["trainer"]["max_steps"] = 4
    if ema:
        raw["trainer"]["extra"] = {"ema_decay": 0.5}
    cfg = tmp_path / "lora.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "r"]) == 0
    run_dir = str(tmp_path / "runs" / "r")
    flag = ["--ema"] if ema else []
    outs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{name}.pt"
        assert run_cli(main, ["export-checkpoint", "--config", str(cfg), "--from", run_dir,
                              "--output", str(out), "--json", *flag]) == 0, name
        outs.append(torch.load(out, weights_only=True))
    theirs, ours = outs
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert torch.equal(ours[key], theirs[key]), key
    # The merged export generates through the plain config.
    plain = dict(raw, model={**raw["model"], "extra": {}})
    (tmp_path / "plain.yaml").write_text(yaml.safe_dump(plain))
    assert run_cli(port_main, ["import-checkpoint", "--config", str(tmp_path / "plain.yaml"),
                               "--input", str(tmp_path / "port.pt"), "--output",
                               str(tmp_path / "imported"), "--json"]) == 0
    assert run_cli(port_main, ["generate", "--config", str(tmp_path / "plain.yaml"), "--from",
                               str(tmp_path / "imported"), "--prompt-ids", "1,2,3",
                               "--max-new-tokens", "4", "--temperature", "0"]) == 0
