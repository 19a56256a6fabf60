"""The port's checkpoints against the JAX package's, both ways.

The JAX ``CheckpointManager`` writes real checkpoints (flax msgpack
payload, sha-256 sidecar, commit manifest) into ``tmp_path``; the port
reads them without flax, params bit-equal to the JAX reader's. The port
writes checkpoints that JAX's ``CheckpointManager.load``,
``verify_manifest`` and ``load_inference_params`` accept, giving the same
logits (atol/rtol 2e-5); its msgpack writer is byte-equal to flax's; its
pruning keeps the last k and sweeps dead stages; and a resume from step k
lands on the uninterrupted run's parameters exactly (CPU, one process).
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


# ---------------------------------------------------------------- write side


def _port_checkpoint(directory, step: int, seed: int, **jax_kw):
    """A checkpoint the port writes: carried weights, an AdamW state."""
    from llmtrain_tpu_torch.config.schemas import TrainerConfig
    from llmtrain_tpu_torch.interop import state_dict_to_flax_gpt_params
    from llmtrain_tpu_torch.training.optimizer import AdamW
    from torch_port_helpers import port_gpt

    jm, params = jax_gpt(seed=seed, **jax_kw)
    tm = port_gpt(jm, params)
    opt = AdamW(list(tm.named_parameters()), TrainerConfig(max_steps=2, warmup_steps=0))
    host = {
        "params": state_dict_to_flax_gpt_params(
            tm.state_dict(), n_heads=jm.n_heads, n_kv_heads=jm.n_kv_heads
        ),
        "opt_state": opt.state_dict(),
    }
    manager = ckpt.CheckpointManager(directory, keep_last_k=5)
    return jm, tm, manager.save_host(step, host, {"run": {"name": "t"}})


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=2, tie_embeddings=False)],
                         ids=["tied-mha", "untied-gqa"])
def test_jax_reader_accepts_a_checkpoint_the_port_wrote(tmp_path, kw) -> None:
    from flax.linen import meta as nn_meta

    from llmtrain_tpu.training.checkpoint import load_inference_params as jax_load

    jm, tm, path = _port_checkpoint(tmp_path, 4, seed=31, **kw)
    manager = JaxCheckpointManager(tmp_path)
    assert manager.verify_manifest(path) and manager.latest_valid_checkpoint() == path
    payload = JaxCheckpointManager.load(path)
    assert int(payload["step"]) == 4 and int(payload["opt_state"]["count"]) == 0
    ids = jnp.asarray(seeded_ids(32, (1, 12), TINY["vocab_size"]))
    abstract = nn_meta.unbox(jax.eval_shape(lambda: jm.init(jax.random.key(0), ids))["params"])
    params, step = jax_load(path, abstract)
    assert step == 4
    expected = np.asarray(jax.jit(jm.apply)({"params": params}, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(ids)).long()).numpy()
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=2e-5)


def test_msgpack_writer_is_byte_equal_to_flax() -> None:
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "i32": np.array([1, -2], np.int32),
        "scalar": np.int64(7),
        "zero_d": np.asarray(2.5),
        "nested": {"s": "yaml", "n": 3, "flag": False, "none": None},
    }
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    bf16 = torch.linspace(-3, 3, 7).bfloat16()
    theirs = serialization.msgpack_restore(ckpt.msgpack_serialize({"w": bf16}))["w"]
    np.testing.assert_array_equal(_as_bits(theirs), _as_bits(bf16))


def test_prune_keeps_last_k_and_sweeps_dead_stages(tmp_path) -> None:
    manager = ckpt.CheckpointManager(tmp_path, keep_last_k=2)
    host = {"params": {"w": np.ones(3, np.float32)}, "opt_state": {"count": np.int32(0)}}
    for step in (1, 2, 3):
        manager.save_host(step, host, {"run": {"name": "t"}})
    (tmp_path / "step_000003.ckpt.tmp").write_bytes(b"torn")
    torn = tmp_path / "step_000004.ckpt"
    torn.write_bytes(b"not a payload")
    complete = tmp_path / "step_000005.ckpt"
    complete.write_bytes(ckpt.msgpack_serialize({
        "checkpoint_version": 1, "step": np.int64(5), "params": {}, "opt_state": {},
        "config_yaml": "",
    }))
    manager.save_host(6, host, {"run": {"name": "t"}})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert not any(n.endswith(".tmp") for n in names) and "step_000004.ckpt" not in names
    assert [p.name for p in manager.all_checkpoints()] == ["step_000005.ckpt", "step_000006.ckpt"]
    assert ckpt.read_manifest(complete)["synthesized"] is True
    assert JaxCheckpointManager(tmp_path).latest_valid_checkpoint().name == "step_000006.ckpt"


def test_resume_from_step_k_equals_the_uninterrupted_run(tmp_path) -> None:
    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(4)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.py").write_text(" ".join(rng.choice(["def", "x", "=", "1", "\n"], size=3000)))
    raw = {
        "run": {"name": "resume", "device": "cpu", "seed": 3, "deterministic": False},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "attention": "flash",
                  "extra": {"tokenizer": "byte"}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 6, "micro_batch_size": 4, "grad_accum_steps": 2, "lr": 3e-3,
                    "warmup_steps": 2, "log_every_steps": 3, "eval_every_steps": 3,
                    "save_every_steps": 3},
        "mlflow": {"enabled": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }
    cfg = RunConfig.model_validate(raw)
    full = Trainer(cfg, tmp_path / "runs" / "full")
    result = full.fit()
    resumed = Trainer(cfg, tmp_path / "runs" / "resumed")
    again = resumed.fit(resume_from=str(tmp_path / "runs" / "full" / "checkpoints" /
                                        "step_000003.ckpt"))
    assert again.resumed_from_step == 3 and again.final_step == 6
    assert again.final_loss == result.final_loss
    for (name, a), (_, b) in zip(full.model.named_parameters(), resumed.model.named_parameters()):
        assert torch.equal(a, b), name
    resumed_ckpts = ckpt.CheckpointManager(tmp_path / "runs" / "resumed" / "checkpoints")
    assert [p.name for p in resumed_ckpts.all_checkpoints()] == ["step_000006.ckpt"]
