"""The port's HF Llama conversion (interop/llama_hf.py) against the JAX
package's, on the CPU: conversion only, nothing is fetched.

* ``llama_params_to_hf_state_dict`` and ``llama_params_from_hf_state_dict``
  on the same arrays as JAX's functions: the same keys, bit for bit, for
  the GQA and fused-MHA trees, Qwen2's q/k/v biases and Gemma's tied
  head; the same errors for an MoE tree, a mismatched tied head and a
  missing or unexpected key;
* ``export-checkpoint`` of a llama run equal, tensor for tensor, to what
  JAX's CLI exports from the same checkpoint; ``import-checkpoint`` of it
  equal to JAX's import, and ``eval`` of the import bit-identical to
  ``eval`` of the run.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import REPO_ROOT, random_params, run_cli

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.interop import llama_hf as jax_hf
from llmtrain_tpu.registry import get_model_adapter as jax_adapter
from llmtrain_tpu.registry import initialize_registries as jax_registries
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.interop import llama_hf

TREES = {
    "llama-gqa": ("llama", {"n_kv_heads": 2}, {}),
    "llama-mha": ("llama", {}, {}),
    "qwen2-gqa": ("qwen2", {"n_kv_heads": 2}, {}),
    "qwen2-mha": ("qwen2", {}, {}),
    "gemma-tied": ("gemma", {"n_kv_heads": 1}, {}),
    "llama-tied": ("llama", {}, {"tie_embeddings": True}),
}


def _tree(case: str, seed: int = 0):
    name, extra, model = TREES[case]
    jax_registries()
    raw = {"run": {"name": "hf", "device": "cpu"},
           "model": {"name": name, "block_size": 8, "d_model": 32, "n_layers": 2, "n_heads": 4,
                     "d_ff": 48, "vocab_size": 41, "dropout": 0.0, "extra": extra, **model},
           "data": {"name": "dummy_text"}, "trainer": {"max_steps": 2, "warmup_steps": 0}}
    jm = jax_adapter(name)().build_model(JaxRunConfig.model_validate(raw))
    return serialization.to_state_dict(
        random_params(jm, jnp.zeros((1, 8), jnp.int32), seed=seed))


@pytest.mark.parametrize("case", sorted(TREES))
def test_conversion_equals_jax_bit_for_bit(case: str) -> None:
    params = _tree(case)
    theirs = jax_hf.llama_params_to_hf_state_dict(params)
    ours = llama_hf.llama_params_to_hf_state_dict(params)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(ours[key], np.asarray(value), key)
    # Back, into a template of other values: JAX's tree leaf for leaf.
    template = _tree(case, seed=1)
    back_theirs = jax_hf.llama_params_from_hf_state_dict(theirs, template)
    back_ours = llama_hf.llama_params_from_hf_state_dict(ours, template)
    flat = jax.tree_util.tree_leaves_with_path(back_theirs)
    mine = dict(jax.tree_util.tree_leaves_with_path(back_ours))
    assert len(mine) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(mine[path]), np.asarray(leaf), str(path))
        np.testing.assert_array_equal(np.asarray(mine[path]),
                                      np.asarray(dict(jax.tree_util.tree_leaves_with_path(
                                          params))[path]), str(path))
    assert llama_hf.is_llama_tree(params) and jax_hf.is_llama_tree(params)


def _errors(fn, *args) -> str:
    with pytest.raises(ValueError) as excinfo:
        fn(*args)
    return str(excinfo.value)


def test_refusals_match_jax() -> None:
    params = _tree("llama-gqa")
    moe = {**params, "block_0": {**params["block_0"], "moe_mlp": {}}}
    assert _errors(llama_hf.llama_params_to_hf_state_dict, moe) == \
        _errors(jax_hf.llama_params_to_hf_state_dict, moe)
    sd = jax_hf.llama_params_to_hf_state_dict(params)
    for broken in ({k: v for k, v in sd.items() if "k_proj" not in k},
                   {**sd, "model.layers.9.mlp.up_proj.weight": sd["lm_head.weight"]}):
        assert _errors(llama_hf.llama_params_from_hf_state_dict, broken, params) == \
            _errors(jax_hf.llama_params_from_hf_state_dict, broken, params)
    tied = _tree("llama-tied")
    untied_sd = {**jax_hf.llama_params_to_hf_state_dict(tied),
                 "lm_head.weight": np.ones((41, 32), np.float32)}
    assert _errors(llama_hf.llama_params_from_hf_state_dict, untied_sd, tied) == \
        _errors(jax_hf.llama_params_from_hf_state_dict, untied_sd, tied)


def test_export_and_import_match_jax_cli(tmp_path, capsys) -> None:
    from llmtrain_tpu.cli import main as jax_main
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    raw = yaml.safe_load((REPO_ROOT / "configs/presets/llama_smoke.yaml").read_text())
    raw["trainer"].update(max_steps=2, eval_every_steps=2, save_every_steps=2)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    cfg = tmp_path / "llama.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "r"]) == 0
    run_dir = str(tmp_path / "runs" / "r")
    exports = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{name}.pt"
        assert run_cli(main, ["export-checkpoint", "--config", str(cfg), "--from", run_dir,
                              "--output", str(out), "--json"]) == 0, name
        exports.append(torch.load(out, weights_only=True))
    theirs, ours = exports
    assert sorted(ours) == sorted(theirs) and "model.layers.1.self_attn.k_proj.weight" in ours
    for key in theirs:
        assert torch.equal(ours[key], theirs[key]), key
    imported = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{name}_imported"
        assert run_cli(main, ["import-checkpoint", "--config", str(cfg), "--input",
                              str(tmp_path / "port.pt"), "--output", str(out), "--json"]) == 0
        imported.append(CheckpointManager.load(out / "step_000000.ckpt")["params"])
    flat = jax.tree_util.tree_leaves_with_path(imported[0])
    mine = dict(jax.tree_util.tree_leaves_with_path(imported[1]))
    assert len(flat) == len(mine)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(mine[path]), np.asarray(leaf), str(path))
    capsys.readouterr()
    losses = []
    for spec in (run_dir, str(tmp_path / "port_imported")):
        assert run_cli(port_main, ["eval", "--config", str(cfg), "--from", spec, "--json"]) == 0
        losses.append(json.loads(capsys.readouterr().out)["metrics"]["val/loss"])
    assert losses[0] == losses[1]
