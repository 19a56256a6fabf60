"""The port's int8 serving quantization against ``llmtrain_tpu/ops/quant.py``.

* ``quantize_array``: codes and scales equal to JAX's on the same f32
  input (both divide in f32 and round half to even), an all-zero channel
  scale 1.0;
* ``quantize_tree`` over the port's parameters against JAX's over the flax
  tree of the same weights: the same leaves quantized (embeddings per row,
  out_proj over the larger of heads and head dim), codes and scales equal
  after the (in, out) -> (out, in) transpose, ``quant_stats`` equal;
  min_size, biases, double quantization, ``dequantize_tree``;
* an int8-weight GPT's logits against JAX's int8-weight GPT (atol/rtol
  2e-5), on the full forward and through generate()'s KV-cache decode;
  ``dequantize_model`` restores the parameters;
* ``python -m llmtrain_tpu_torch generate --quantize int8`` in a
  subprocess emits JAX's CLI ids on the same checkpoint.
"""

from __future__ import annotations

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import (
    jax_gpt, port_env, port_gpt, random_params, run_cli, seeded_ids, to_torch,
)

from llmtrain_tpu import cli as jax_cli
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu.generation import generate as jax_generate
from llmtrain_tpu.ops.quant import QuantizedArray as JaxQuantizedArray
from llmtrain_tpu.ops.quant import quant_stats as jax_quant_stats
from llmtrain_tpu.ops.quant import quantize_array as jax_quantize_array
from llmtrain_tpu.ops.quant import quantize_tree as jax_quantize_tree
from llmtrain_tpu.registry import get_model_adapter, initialize_registries
from llmtrain_tpu.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict
from llmtrain_tpu_torch.ops.quant import (
    QuantizedArray,
    dequantize_model,
    dequantize_tree,
    model_tree,
    quant_stats,
    quantize_array,
    quantize_model,
    quantize_tree,
)

ATOL = RTOL = 2e-5


@pytest.mark.parametrize("shape, axes", [((48, 96), (0,)), ((48, 96), (1,)),
                                         ((6, 5, 40), (2,)), ((6, 5, 40), (0, 1))])
def test_quantize_array_matches_jax(shape, axes) -> None:
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3.0
    x[1] = 0.0  # an all-zero slice: scale 1.0 where the channel is all zero
    theirs = jax_quantize_array(jnp.asarray(x), reduce_axes=axes)
    ours = quantize_array(to_torch(x), reduce_axes=axes)
    assert ours.q.dtype == torch.int8 and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(theirs.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs.scale))
    np.testing.assert_array_equal(ours.dequantize().numpy(), np.asarray(theirs.dequantize()))
    assert ours.nbytes == theirs.nbytes and ours.numel() == theirs.size


def _flax_tree(qtree, pick):
    """A flax param tree with ``pick(leaf)`` in place of every quantized
    leaf and the leaf itself elsewhere."""
    return jax.tree.map(lambda a: np.asarray(pick(a)) if isinstance(a, JaxQuantizedArray)
                        else np.asarray(a), qtree,
                        is_leaf=lambda a: isinstance(a, JaxQuantizedArray))


_TREES = [dict(), dict(tie_embeddings=False, n_kv_heads=2),
          dict(d_model=64, n_heads=16, d_ff=128)]


@pytest.mark.parametrize("kw", _TREES, ids=["tied", "untied-gqa", "heads-over-head-dim"])
def test_quantize_tree_matches_jax(kw) -> None:
    """Codes, scales (broadcast to the weight) and the quantized set as
    JAX's, mapped to the port's layout by the carry-over transforms; in
    the last case out_proj's scale runs over the heads (16 > 4)."""
    jm, params = jax_gpt(seed=2, **kw)
    tm = port_gpt(jm, params)
    theirs = jax_quantize_tree(params, min_size=1024)
    ours = quantize_tree(model_tree(tm), n_heads=jm.n_heads, min_size=1024)
    codes = flax_gpt_params_to_state_dict(_flax_tree(theirs, lambda a: a.q))
    scales = flax_gpt_params_to_state_dict(
        _flax_tree(theirs, lambda a: jnp.broadcast_to(a.scale, a.shape)))
    quantized = flax_gpt_params_to_state_dict(
        _flax_tree(theirs, lambda a: np.ones(a.shape, np.int8)))
    assert set(ours) == set(codes)
    for name, leaf in ours.items():
        if isinstance(leaf, QuantizedArray):
            assert quantized[name].dtype == torch.int8, name
            np.testing.assert_array_equal(leaf.q.numpy(), codes[name].numpy(), err_msg=name)
            full = (torch.ones(leaf.view) * leaf.scale).view(leaf.shape)
            np.testing.assert_array_equal(full.numpy(), scales[name].numpy(), err_msg=name)
        else:
            assert quantized[name].dtype != torch.int8, name
    assert quant_stats(ours) == jax_quant_stats(theirs)
    assert any(isinstance(a, QuantizedArray) for a in ours.values())


def test_quantize_tree_rules() -> None:
    jm, params = jax_gpt(seed=3)
    tm = port_gpt(jm, params)
    tree = quantize_tree(model_tree(tm), n_heads=jm.n_heads)  # default min_size 4096
    for name, leaf in tree.items():
        big = leaf.ndim >= 2 and leaf.numel() >= 4096 and not name.endswith("bias")
        assert isinstance(leaf, QuantizedArray) == big, name
    assert tree["blocks.0.mlp_fc.weight"].scale.shape == (128, 1)  # per output channel
    small = quantize_tree(model_tree(tm), n_heads=jm.n_heads, min_size=1024)
    assert small["token_embedding.weight"].scale.shape == (61, 1)  # per row
    with pytest.raises(ValueError, match="already quantized"):
        quantize_tree(tree, n_heads=jm.n_heads)
    plain = dequantize_tree(tree)
    assert not any(isinstance(a, QuantizedArray) for a in plain.values())
    np.testing.assert_array_equal(plain["blocks.0.mlp_fc.weight"].numpy(),
                                  tree["blocks.0.mlp_fc.weight"].dequantize().numpy())


@pytest.mark.parametrize("kw", [dict(), dict(tie_embeddings=False, n_kv_heads=2)],
                         ids=["tied", "untied-gqa"])
def test_int8_weight_gpt_matches_jax(kw) -> None:
    jm, params = jax_gpt(seed=4, **kw)
    tm = port_gpt(jm, params)
    qparams = jax_quantize_tree(params, min_size=1024)
    stats = quantize_model(tm, min_size=1024)
    assert stats == jax_quant_stats(qparams)
    with pytest.raises(ValueError, match="already quantized"):
        quantize_model(tm)
    ids = seeded_ids(5, (2, 24), 61)
    j = jax.jit(jm.apply)({"params": qparams}, jnp.asarray(ids))
    with torch.no_grad():
        t = tm(to_torch(ids).long())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    prompt = seeded_ids(6, (1, 7), 61)
    ours = generate(tm, prompt, max_new_tokens=16, temperature=0.0)
    theirs = jax_generate(jm, qparams, prompt, max_new_tokens=16, temperature=0.0)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    dequantize_model(tm)
    restored = dict(tm.named_parameters())
    assert all(not isinstance(a, QuantizedArray) for a in model_tree(tm).values())
    expected = flax_gpt_params_to_state_dict(_flax_tree(qparams, lambda a: a.dequantize()))
    for name, p in restored.items():
        np.testing.assert_array_equal(p.detach().numpy(), expected[name].numpy(), err_msg=name)


def test_generate_quantized_subprocess_matches_jax_cli(tmp_path, capsys) -> None:
    raw = {
        "run": {"name": "q", "seed": 0, "device": "cpu"},
        "model": {"name": "gpt", "block_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
                  "d_ff": 128, "dropout": 0.0, "vocab_size": 61, "attention": "dense"},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 1, "warmup_steps": 0},
        "logging": {"level": "INFO"},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }
    cfg_path = tmp_path / "q.yaml"
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, resolved = jax_load(cfg_path)
    initialize_registries()
    model = get_model_adapter("gpt")().build_model(cfg)
    params = random_params(model, jnp.zeros((1, 64), jnp.int32), seed=7)
    ckpt = CheckpointManager(tmp_path / "ckpts").save_host(
        5, {"params": serialization.to_state_dict(params), "opt_state": {}}, resolved)
    argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt), "--prompt-ids",
            "2,7,1,8,2,8", "--max-new-tokens", "30", "--temperature", "0", "--quantize", "int8",
            "--json"]
    proc = subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", *argv], cwd=tmp_path,
                          env=port_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ours = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "int8 weight quantization" in proc.stderr
    assert run_cli(jax_cli.main, argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["output_ids"] == theirs["output_ids"] and ours["step"] == theirs["step"] == 5
