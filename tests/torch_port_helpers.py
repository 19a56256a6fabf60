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
