"""The port's checkpoint reader against checkpoints the JAX package writes.

The JAX ``CheckpointManager`` writes real checkpoints (flax msgpack
payload, sha-256 sidecar, commit manifest) into ``tmp_path``; the port
reads them without flax. Params must be bit-equal to the JAX reader's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_port_helpers import TINY, jax_gpt, seeded_ids

from llmtrain_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from llmtrain_tpu_torch.models.gpt import GPT
from llmtrain_tpu_torch.training import checkpoint as ckpt


def _save(directory, step: int, params: dict, config: dict | None = None):
    manager = JaxCheckpointManager(directory, keep_last_k=5)
    host_state = {"params": serialization.to_state_dict(params), "opt_state": {"count": np.int32(step)}}
    return manager.save_host(step, host_state, config or {"run": {"name": "t"}})


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _as_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def test_params_bit_equal_to_jax_reader(tmp_path) -> None:
    _, params = jax_gpt(seed=21)
    path = _save(tmp_path, 7, params)
    ours = ckpt.CheckpointManager.load(path)
    theirs = JaxCheckpointManager.load(path)
    assert int(ours["step"]) == 7 and ours["config_yaml"] == theirs["config_yaml"]
    our_leaves, their_leaves = dict(_leaves(ours["params"])), dict(_leaves(theirs["params"]))
    assert our_leaves.keys() == their_leaves.keys()
    for key, value in their_leaves.items():
        a, b = _as_bits(our_leaves[key]), _as_bits(value)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b)


def test_msgpack_reader_matches_flax_on_every_leaf_kind() -> None:
    """bf16 arrays, numpy scalars, ints, strings, bools, None, lists."""
    payload = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "bf16": jnp.asarray(np.linspace(-2, 2, 5), jnp.bfloat16),
        "i32": np.array([1, -2, 3], np.int32),
        "scalar": np.int64(42),
        "nested": {"s": "text", "flag": True, "none": None, "xs": [1, 2.5]},
    }
    blob = serialization.msgpack_serialize(payload)
    ours = ckpt.msgpack_restore(blob)
    theirs = serialization.msgpack_restore(blob)
    for key in ("f32", "i32", "bf16"):
        np.testing.assert_array_equal(_as_bits(ours[key]), _as_bits(theirs[key]))
    assert ours["bf16"].dtype == torch.bfloat16 and tuple(ours["bf16"].shape) == (5,)
    assert ours["scalar"] == theirs["scalar"] == 42
    assert ours["nested"] == {"s": "text", "flag": True, "none": None, "xs": [1, 2.5]}


def test_load_inference_params_gives_jax_logits(tmp_path) -> None:
    jm, params = jax_gpt(seed=22)
    path = _save(tmp_path, 3, params)
    model = GPT(**TINY)
    assert ckpt.load_inference_params(path, model) == 3
    ids = seeded_ids(23, (1, 10), TINY["vocab_size"])
    expected = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=2e-5)


def test_resolves_file_dir_and_run_id_specs(tmp_path) -> None:
    _, params = jax_gpt(seed=24)
    run_ckpts = tmp_path / "runs" / "myrun" / "checkpoints"
    first = _save(run_ckpts, 1, params)
    second = _save(run_ckpts, 2, params)
    root = tmp_path / "runs"
    assert ckpt.resolve_resume_path(str(first), root) == first
    assert ckpt.resolve_resume_path(str(run_ckpts), root) == second
    assert ckpt.resolve_resume_path(str(run_ckpts.parent), root) == second
    assert ckpt.resolve_resume_path("myrun", root) == second
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_resume_path("missing.ckpt", root)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_resume_path("no-such-run", root)


def test_rejects_payload_that_fails_sha256(tmp_path) -> None:
    _, params = jax_gpt(seed=25)
    good = _save(tmp_path, 1, params)
    bad = _save(tmp_path, 2, params)
    blob = bytearray(bad.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    bad.write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointError, match="sha-256"):
        ckpt.CheckpointManager.load(bad)
    assert not ckpt.CheckpointManager(tmp_path).verify_manifest(bad)
    # Directory resolution skips the damaged newest step.
    assert ckpt.resolve_resume_path(str(tmp_path), tmp_path) == good


def test_config_mismatch_warns(tmp_path, caplog) -> None:
    import logging

    _, params = jax_gpt(seed=26)
    path = _save(tmp_path, 1, params, config={"run": {"name": "a"}})
    payload = ckpt.CheckpointManager.load(path)
    logger = logging.getLogger("llmtrain")
    propagate, logger.propagate = logger.propagate, True
    try:
        with caplog.at_level(logging.WARNING, logger="llmtrain"):
            ckpt.warn_on_config_mismatch(payload, "run:\n  name: b\n", path)
    finally:
        logger.propagate = propagate
    assert "differs from current config" in caplog.text
