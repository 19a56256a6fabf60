"""Shared fixtures-as-functions for the PyTorch port's CPU tests
(tests/test_torch_*.py): a tiny JAX GPT with seeded params, and the port's
GPT carrying the same weights over the interop function.

Every port test module imports this file, which caps torch at one CPU
thread per process: under pytest-xdist each worker would otherwise start a
full intra-op pool, and six workers oversubscribe the cores many times over.
The port's CLI subprocesses get the same cap through :func:`port_env`, so
in-process and subprocess runs that are compared bit for bit use the same
thread count."""

from __future__ import annotations

import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization
from flax.linen import meta as nn_meta

from llmtrain_tpu.models.gpt import GPT as JaxGPT
from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict
from llmtrain_tpu_torch.models.gpt import GPT

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]

TINY = dict(vocab_size=61, block_size=32, d_model=64, n_layers=2, n_heads=4, d_ff=128)


def random_params(module, *args, seed: int = 0) -> dict:
    """Seeded numpy params with the module's param tree (shapes from
    ``jax.eval_shape`` — no compile): N(0, 0.1) everywhere, LayerNorm
    scales around 1."""
    shapes = nn_meta.unbox(
        jax.eval_shape(lambda: module.init(jax.random.key(0), *args))["params"]
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        return x + 1.0 if getattr(path[-1], "key", None) == "scale" else x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_gpt(seed: int = 0, **overrides) -> tuple[JaxGPT, dict]:
    """A tiny flax GPT and seeded params for it (host numpy tree)."""
    kw = {**TINY, "dropout": 0.0, **overrides}
    model = JaxGPT(**kw)
    tokens = jnp.zeros((1, kw["block_size"]), jnp.int32)
    return model, random_params(model, tokens, seed=seed)


def port_gpt(jax_model: JaxGPT, params: dict) -> GPT:
    """The port's GPT with the JAX model's hyper-parameters and weights."""
    model = GPT(
        vocab_size=jax_model.vocab_size,
        block_size=jax_model.block_size,
        d_model=jax_model.d_model,
        n_layers=jax_model.n_layers,
        n_heads=jax_model.n_heads,
        d_ff=jax_model.d_ff,
        tie_embeddings=jax_model.tie_embeddings,
        attention=jax_model.attention,
        n_kv_heads=jax_model.n_kv_heads,
        assume_packed=jax_model.assume_packed,
        sliding_window=jax_model.sliding_window,
    )
    sd = flax_gpt_params_to_state_dict(serialization.to_state_dict(params))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def run_cli(main, argv: list[str]) -> int:
    """A CLI ``main`` in-process, restoring the shared ``llmtrain`` logger
    afterwards: both CLIs point its stream handler at the current stderr
    (pytest's capture, closed after the test), which would break every
    later test in this process that logs."""
    logger = logging.getLogger("llmtrain")
    saved = (logger.propagate, logger.level, list(logger.handlers))
    streams = {h: h.stream for h in saved[2] if isinstance(h, logging.StreamHandler)}
    try:
        return main(argv)
    finally:
        logger.propagate, level, handlers = saved
        logger.setLevel(level)
        for h in list(logger.handlers):
            if h not in handlers:
                logger.removeHandler(h)
        for h, stream in streams.items():
            h.setStream(stream)


class _ForeignDeviceTensor(torch.Tensor):
    """A storage-free tensor on a device the port does not run on."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device=torch.device("xla"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor without storage")


def foreign_device_tensor(shape: tuple[int, ...], dtype=torch.float32) -> torch.Tensor:
    """A tensor on neither the CPU, the card nor ``meta`` (the cost count's
    device): the kernel wrappers must refuse it before touching it."""
    return _ForeignDeviceTensor(shape, dtype)


def seeded_ids(seed: int, shape: tuple[int, ...], vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def port_env(**extra: str) -> dict[str, str]:
    """Environment for a ``python -m llmtrain_tpu_torch`` child: the repo on
    ``PYTHONPATH`` and torch's CPU threads capped at one, as here."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def paired_fit(raw: dict, directory: Path, steps: int | None = None
               ) -> tuple[list[float], list[float], object, object]:
    """``fit`` of the JAX trainer and of the port's on one config (a dict
    written under ``directory``), the port's model first given the JAX
    trainer's initial params through the carry-over: (JAX's per-step
    losses, the port's, JAX's TrainResult, the port's). Log every step to
    get every loss.

    JAX spreads the batch over the test session's virtual CPU devices (its
    global micro-batch is ``micro_batch_size`` x devices), so its config
    gets ``micro_batch_size / devices``: both runs then train on the same
    global batches, which must divide by the device count. ``steps`` stops
    both runs early (``fit``'s ``max_steps_override``; the schedule still
    spans ``trainer.max_steps``)."""
    from unittest import mock

    import yaml

    from llmtrain_tpu.config import load_and_validate_config as jax_load_config
    from llmtrain_tpu.registry import initialize_registries
    from llmtrain_tpu.tracking.base import NullTracker
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.interop import flax_params_to_state_dict
    from llmtrain_tpu_torch.training.trainer import Trainer

    devices = len(jax.devices())
    micro = raw["trainer"]["micro_batch_size"]
    assert micro % devices == 0, f"micro_batch_size {micro} must divide by {devices} devices"
    jax_raw = {**raw, "trainer": {**raw["trainer"], "micro_batch_size": micro // devices}}
    paths = []
    for name, cfg in (("jax", jax_raw), ("port", raw)):
        paths.append(Path(directory) / f"paired_{name}.yaml")
        paths[-1].write_text(yaml.safe_dump(cfg, sort_keys=False))

    def recording(cls, sink: list):
        original = cls._log_train_interval

        def log_interval(self, **kw):
            sink.extend(float(x) for x in np.asarray(kw["losses_host"]))
            return original(self, **kw)

        return mock.patch.object(cls, "_log_train_interval", log_interval)

    initialize_registries()
    jax_trainer = JaxTrainer(jax_load_config(paths[0])[0], None, NullTracker())
    port_trainer = Trainer(load_and_validate_config(paths[1])[0], None)
    params = jax.device_get(serialization.to_state_dict(nn_meta.unbox(jax_trainer._state.params)))
    port_trainer.model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    jax_losses: list[float] = []
    port_losses: list[float] = []
    with recording(JaxTrainer, jax_losses), recording(Trainer, port_losses):
        jax_result = jax_trainer.fit(steps)
        port_result = port_trainer.fit(steps)
    return jax_losses, port_losses, jax_result, port_result
