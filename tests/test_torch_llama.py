"""The port's llama family against the JAX package's, on the CPU: llama,
Mistral (llama with ``sliding_window``), Qwen2 and Gemma.

Each family is built by its adapter on both sides from the same config
(d 64, 2 layers, 4 query heads over 2 KV heads, f32), the JAX params made
from a seed with numpy and carried over by interop/flax_params.py:

* logits within atol/rtol 2e-5, with and without a padding mask, on the
  dense and flash paths (JAX's flash on the CPU is its blockwise
  fallback, the port's its plain version);
* the gradients of the loss within atol 1e-5, rtol 1e-4, the loss itself
  through ``dense``, ``chunked_ce`` and ``fused_ce`` (JAX's Pallas kernel
  in interpret mode);
* the decode cache (the rolling ring under a window) against the full
  forward and against JAX's decode clone, and paged continuous serving:
  the llama engine's tokens bitwise ``generate()``'s;
* a few optimizer steps of ``mistral_smoke`` from JAX's initial params
  within the trajectory band (atol 3e-5, rtol 1e-3);
* the adapters' checks and refusals: JAX's messages, the tie default,
  Qwen2's 1e6 RoPE base, ``fused_norm`` refused with JAX's exit code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import REPO_ROOT, paired_fit, random_params, seeded_ids, to_torch

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.models.gemma import GemmaAdapter as JaxGemma
from llmtrain_tpu.models.llama import LlamaAdapter as JaxLlama
from llmtrain_tpu.models.qwen2 import Qwen2Adapter as JaxQwen2
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.interop.flax_params import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from llmtrain_tpu_torch.models.gemma import GemmaAdapter
from llmtrain_tpu_torch.models.llama import LlamaAdapter, RMSNorm
from llmtrain_tpu_torch.models.qwen2 import Qwen2Adapter
from llmtrain_tpu_torch.serving import ContinuousBatchingScheduler, PagedDecodeEngine, ServeRequest
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry

ATOL = RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
VOCAB, BLOCK = 61, 32
FAMILIES = {
    "llama": (JaxLlama, LlamaAdapter, "llama", {}),
    "mistral": (JaxLlama, LlamaAdapter, "llama", {"sliding_window": 6}),
    "qwen2": (JaxQwen2, Qwen2Adapter, "qwen2", {}),
    "gemma": (JaxGemma, GemmaAdapter, "gemma", {}),
}


def _raw(name: str, *, attention: str = "dense", extra: dict | None = None, **model) -> dict:
    return {
        "run": {"name": "zoo", "device": "cpu", "seed": 3},
        "model": {"name": name, "block_size": BLOCK, "d_model": 64, "n_layers": 2,
                  "n_heads": 4, "d_ff": 96, "dropout": 0.0, "vocab_size": VOCAB,
                  "attention": attention, "extra": {"n_kv_heads": 2, **(extra or {})}, **model},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 2, "warmup_steps": 0},
    }


def _pair(family: str, **kw):
    """(JAX module, JAX params, port module) of one family, same weights."""
    jax_cls, port_cls, name, extra = FAMILIES[family]
    raw = _raw(name, extra={**extra, **kw.pop("extra", {})}, **kw)
    jm = jax_cls().build_model(JaxRunConfig.model_validate(raw))
    params = random_params(jm, jnp.zeros((1, BLOCK), jnp.int32), seed=len(family))
    tm = port_cls().build_model(RunConfig.model_validate(raw))
    tm.load_state_dict(flax_params_to_state_dict(serialization.to_state_dict(params)),
                       strict=True)
    return jm, params, tm


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return (request.param, *_pair(request.param))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_logits_match_jax(family, masked: bool) -> None:
    name, jm, params, tm = family
    ids = seeded_ids(1, (2, BLOCK), VOCAB)
    mask = None
    if masked:
        mask = np.ones_like(ids)
        mask[1, 21:] = 0
    want = jm.apply({"params": params}, jnp.asarray(ids), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tm(to_torch(ids).long(), None if mask is None else to_torch(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_flash_path_matches_jax() -> None:
    """The windowed GQA flash path (Mistral's training path) against
    JAX's flash module."""
    jm, params, tm = _pair("mistral", attention="flash")
    ids = seeded_ids(4, (2, BLOCK), VOCAB)
    want = jm.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(to_torch(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_carry_over_round_trips(family) -> None:
    name, jm, params, tm = family
    back = state_dict_to_flax_params(tm.state_dict(), n_heads=4, n_kv_heads=2)
    flat = jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(params))
    mine = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), back)))
    assert len(flat) == len(mine)
    for path, leaf in flat:
        np.testing.assert_array_equal(mine[path], np.asarray(leaf), str(path))


def _loss_grads(jax_adapter, jm, params, port_adapter, tm, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_adapter.compute_loss(jm, p, jbatch), has_aux=True)(params)
    tm.zero_grad()
    loss, _ = port_adapter.compute_loss(tm, {k: to_torch(v) for k, v in batch.items()})
    loss.backward()
    return float(jloss), float(loss.detach()), jgrads


@pytest.mark.parametrize("loss_impl", ["dense", "chunked_ce", "fused_ce"])
def test_loss_and_gradients_match_jax(family, loss_impl: str) -> None:
    name, _, params, _ = family
    jax_cls, port_cls, model_name, extra = FAMILIES[name]
    raw = _raw(model_name, extra={**extra, "loss_impl": loss_impl, "pallas_interpret": True,
                                  "ce_chunk": 16, "fused_ce_block_t": 32,
                                  "fused_ce_block_v": 32})
    jm = jax_cls().build_model(JaxRunConfig.model_validate(raw))
    tm = port_cls().build_model(RunConfig.model_validate(raw))
    tm.load_state_dict(flax_params_to_state_dict(serialization.to_state_dict(params)))
    assert tm.loss_impl == loss_impl
    ids = seeded_ids(5, (2, BLOCK + 1), VOCAB)
    mask = np.ones((2, BLOCK), np.int32)
    mask[0, 25:] = 0
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:], "attention_mask": mask}
    jloss, loss, jgrads = _loss_grads(jax_cls(), jm, params, port_cls(), tm, batch)
    assert abs(loss - jloss) <= ATOL + RTOL * abs(jloss)
    want = flax_params_to_state_dict(jax.device_get(serialization.to_state_dict(jgrads)))
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=pname)


def _jax_decode(jm, params, ids, chunks):
    dm = jm.for_decoding()
    shapes = jax.eval_shape(lambda: dm.init(jax.random.key(0),
                                            jnp.zeros((ids.shape[0], 1), jnp.int32)))["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    out, start = [], 0
    for n in chunks:
        logits, mutated = dm.apply({"params": params, "cache": cache},
                                   jnp.asarray(ids[:, start:start + n]), mutable=["cache"])
        cache, start = mutated["cache"], start + n
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def test_decode_cache_matches_full_forward_and_jax(family) -> None:
    """A prefill no longer than the window, then one token a call past it:
    under Mistral's window the ring wraps, every call still exact."""
    name, jm, params, tm = family
    ids = seeded_ids(6, (2, 20), VOCAB)
    chunks = [5] + [1] * 15
    decoder = tm.for_decoding()
    cache = decoder.init_cache(2)
    if name == "mistral":
        assert decoder.slots == 6 and cache.layers[0].pos1 is not None
    with torch.no_grad():
        got = torch.cat([decoder(to_torch(ids[:, s:s + n]).long(), cache)
                         for s, n in zip(np.cumsum([0] + chunks[:-1]), chunks)], dim=1).numpy()
        full = tm(to_torch(ids).long()).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _jax_decode(jm, params, ids, chunks), atol=ATOL, rtol=RTOL)


def test_paged_serving_is_bitwise_generate() -> None:
    """Continuous batching of the llama model: every request's greedy and
    sampled tokens are those of the port's generate() for it alone."""
    _, _, tm = _pair("llama")
    engine = PagedDecodeEngine(tm, block_tokens=8, max_batch_slots=4,
                               prompt_buckets=[8, 16, BLOCK], batch_buckets=[2, 4])
    scheduler = ContinuousBatchingScheduler(engine, registry=MetricsRegistry())
    rng = np.random.default_rng(7)
    requests = [ServeRequest(prompt_ids=rng.integers(0, VOCAB, int(rng.integers(2, 14))).astype(
                    np.int32), seed=50 + i, max_new_tokens=int(rng.integers(4, 12)),
                    temperature=0.0 if i % 2 else 0.9, top_k=None if i % 2 else 7)
                for i in range(6)]
    for req in requests:
        scheduler.submit(req)
    steps = 0
    while not all(r.done.is_set() for r in requests):
        scheduler.step()
        steps += 1
        assert steps < 300
    assert scheduler.peak_occupancy >= 2
    for req in requests:
        gen = torch.Generator()
        gen.manual_seed(req.seed)
        out = generate(tm, req.prompt_ids[None, :], max_new_tokens=req.max_new_tokens,
                       temperature=req.temperature, top_k=req.top_k, generator=gen)
        assert req.tokens == [int(t) for t in out[0, req.prompt_ids.shape[0]:]]


def test_paged_decoding_refuses_window_and_int8_as_jax() -> None:
    for extra, needle in (({"sliding_window": 6}, "sliding_window"),
                          ({"kv_cache_dtype": "int8"}, "kv_cache_dtype")):
        jm, _, tm = _pair("llama", extra=extra)
        with pytest.raises(ValueError) as theirs:
            jm.for_paged_decoding(num_blocks=4, block_tokens=8)
        with pytest.raises(ValueError) as ours:
            tm.for_paged_decoding(num_blocks=4, block_tokens=8)
        assert str(ours.value) == str(theirs.value) and needle in str(ours.value)


def test_rms_norm_matches_jax() -> None:
    from llmtrain_tpu.models.llama import RMSNorm as JaxRMSNorm

    x = np.random.default_rng(8).normal(size=(3, 5, 64)).astype(np.float32) * 3.0
    scale = np.random.default_rng(9).normal(size=(64,)).astype(np.float32)
    for offset in (False, True):
        want = JaxRMSNorm(offset=offset).apply({"params": {"scale": scale}}, jnp.asarray(x))
        norm = RMSNorm(64, dtype=torch.float32, param_dtype=torch.float32, offset=offset)
        norm.weight.data = to_torch(scale)
        np.testing.assert_allclose(norm(to_torch(x)).detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


def test_adapters_resolve_as_jax() -> None:
    """Qwen2's RoPE base, Gemma's knobs, the untied default, and an
    explicit tie_embeddings winning, as JAX's adapters resolve them."""
    cases = [("llama", {}), ("qwen2", {}), ("qwen2", {"extra": {"rope_theta": 5e5}}),
             ("gemma", {}), ("gemma", {"tie_embeddings": False}),
             ("llama", {"tie_embeddings": True})]
    adapters = {"llama": (JaxLlama, LlamaAdapter), "qwen2": (JaxQwen2, Qwen2Adapter),
                "gemma": (JaxGemma, GemmaAdapter)}
    for name, kw in cases:
        raw = _raw(name, extra=kw.get("extra"), **{k: v for k, v in kw.items() if k != "extra"})
        jax_cls, port_cls = adapters[name]
        jm = jax_cls().build_model(JaxRunConfig.model_validate(raw))
        kwargs = port_cls().model_kwargs(RunConfig.model_validate(raw))
        assert kwargs["tie_embeddings"] == jm.tie_embeddings, (name, kw)
        assert kwargs["rope_theta"] == jm.rope_theta, (name, kw)
        assert kwargs.get("qkv_bias", False) == jm.qkv_bias
        assert kwargs.get("mlp_act", "silu") == jm.mlp_act
        assert kwargs.get("norm_offset", False) == jm.norm_offset
        assert kwargs.get("embed_scale", False) == jm.embed_scale


@pytest.mark.parametrize("extra, model", [
    ({"fused_norm": True}, {}),
    ({"rope_theta": 0.0}, {}),
    ({"rms_norm_eps": -1.0}, {}),
    ({"n_kv_heads": 3}, {"n_heads": 6, "d_model": 66}),
], ids=["fused_norm", "rope_theta", "rms_norm_eps", "odd_head_dim"])
def test_adapter_refusals_match_jax(extra: dict, model: dict) -> None:
    raw = _raw("llama", extra=extra, **model)
    with pytest.raises(ValueError) as theirs:
        JaxLlama().build_model(JaxRunConfig.model_validate(raw))
    with pytest.raises(ValueError) as ours:
        LlamaAdapter().build_model(RunConfig.model_validate(raw))
    assert str(ours.value) == str(theirs.value)


def test_fused_norm_config_exits_as_jax(tmp_path, capsys) -> None:
    """``fused_norm`` on a llama config is the adapter's ValueError inside
    the trainer: both CLIs end ``train`` with the same exit code (1, a
    training failure, as JAX's exit-code walk gives a ValueError)."""
    from torch_port_helpers import run_cli

    from llmtrain_tpu.cli import main as jax_main
    from llmtrain_tpu_torch.cli import main as port_main

    raw = yaml.safe_load((REPO_ROOT / "configs/presets/llama_smoke.yaml").read_text())
    raw["model"]["extra"]["fused_norm"] = True
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    cfg = tmp_path / "llama_fused.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    codes = [run_cli(main, ["train", "--config", str(cfg), "--run-id", name])
             for name, main in (("jax", jax_main), ("port", port_main))]
    err = capsys.readouterr().err
    assert codes == [1, 1], err
    assert err.count("not supported by the llama family") >= 2


def test_mistral_smoke_tracks_jax(tmp_path) -> None:
    """mistral_smoke (GQA, window 8) from JAX's initial params: per-step
    losses within the optimizer-trajectory band."""
    raw = yaml.safe_load((REPO_ROOT / "configs/presets/mistral_smoke.yaml").read_text())
    raw["trainer"].update(max_steps=128, micro_batch_size=8, log_every_steps=1,
                          eval_every_steps=100, save_every_steps=100)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    jax_losses, port_losses, _, _ = paired_fit(raw, tmp_path, steps=4)
    assert len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
