"""The port's GPT against the JAX GPT with the same weights.

Weights go from the flax param tree to the port's state_dict through the
carry-over function (interop/flax_params.py). Logits are compared in f32
at atol/rtol 2e-5 — the band tests/test_torch_parity.py uses for the same
architecture across frameworks (summation order only). The JAX flash path
on the CPU runs its blockwise implementation, the port's its plain version.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, jax_gpt, port_gpt, random_params, seeded_ids, to_torch

from llmtrain_tpu.models.gpt import CausalSelfAttention as JaxAttention
from llmtrain_tpu.ops.rope import apply_rope as jax_apply_rope
from llmtrain_tpu_torch.models.gpt import CausalSelfAttention
from llmtrain_tpu_torch.ops.rope import apply_rope

ATOL = RTOL = 2e-5

# Each option value (tied/untied lm-head, n_kv_heads 4/2, flash/dense
# attention, with/without a padding mask) appears in at least one case.
CASES = [
    dict(tie_embeddings=True, n_kv_heads=0, attention="flash", masked=True),
    dict(tie_embeddings=False, n_kv_heads=2, attention="flash", masked=False),
    dict(tie_embeddings=True, n_kv_heads=2, attention="dense", masked=True),
    dict(tie_embeddings=False, n_kv_heads=0, attention="dense", masked=False),
]


def _case_id(c: dict) -> str:
    tie = "tied" if c["tie_embeddings"] else "untied"
    return f"{tie}-kv{c['n_kv_heads'] or TINY['n_heads']}-{c['attention']}-" + (
        "mask" if c["masked"] else "nomask"
    )


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_train_shape_logits_match(case: dict) -> None:
    masked = case["masked"]
    kw = {k: v for k, v in case.items() if k != "masked"}
    jm, params = jax_gpt(seed=1, **kw)
    tm = port_gpt(jm, params)
    ids = seeded_ids(2, (2, 24), TINY["vocab_size"])
    mask = None
    if masked:
        mask = np.ones((2, 24), np.int32)
        mask[1, 17:] = 0
    j = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids),
                          None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        t = tm(to_torch(ids).long(), None if mask is None else to_torch(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CASES[:2], ids=_case_id)
def test_decode_clone_matches_jax_for_decoding(case: dict) -> None:
    """Prefill 8 tokens, then 4 single-token steps, logits at each call."""
    kw = {k: v for k, v in case.items() if k != "masked"}
    jm, params = jax_gpt(seed=3, **kw)
    tm = port_gpt(jm, params)
    ids = seeded_ids(4, (2, 12), TINY["vocab_size"])
    dm = jm.for_decoding(cache_len=16)
    shapes = jax.eval_shape(
        lambda: dm.init(jax.random.key(0), jnp.zeros((2, 1), jnp.int32))
    )["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    decoder = tm.for_decoding(cache_len=16)
    kv = decoder.init_cache(2)
    chunks = [ids[:, :8]] + [ids[:, 8 + i : 9 + i] for i in range(4)]
    step = jax.jit(lambda variables, tokens: dm.apply(variables, tokens, mutable=["cache"]))
    for chunk in chunks:
        j, mutated = step({"params": params, "cache": cache}, jnp.asarray(chunk))
        cache = mutated["cache"]
        with torch.no_grad():
            t = decoder(to_torch(chunk).long(), kv)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_rope_matches_jax() -> None:
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    for pos in (np.arange(6), np.arange(12).reshape(2, 6) + 3):
        jq, jk = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
        tq, tk = apply_rope(to_torch(q), to_torch(k), to_torch(pos))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=1e-6)


def _port_attention_from(params: dict, n_kv_heads: int, **kw) -> CausalSelfAttention:
    """Port attention with the JAX attention's weights (the block-level
    slice of the carry-over transforms)."""
    from flax import serialization

    from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict

    tree = {
        "token_embedding": {"embedding": np.zeros((1, 32), np.float32)},
        "position_embedding": {"embedding": np.zeros((1, 32), np.float32)},
        "ln_f": {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)},
        "block_0": {
            "ln_1": {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)},
            "ln_2": {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)},
            "attn": serialization.to_state_dict(params),
            "mlp_fc": {"kernel": np.zeros((32, 32), np.float32), "bias": np.zeros(32, np.float32)},
            "mlp_proj": {"kernel": np.zeros((32, 32), np.float32), "bias": np.zeros(32, np.float32)},
        },
    }
    sd = flax_gpt_params_to_state_dict(tree)
    attn = CausalSelfAttention(32, 4, dtype=torch.float32, param_dtype=torch.float32,
                               n_kv_heads=n_kv_heads, **kw)
    prefix = "blocks.0.attn."
    attn.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return attn.eval()


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_rope_attention_matches_jax(attention: str) -> None:
    """RoPE lives on the attention module (as in JAX, where the llama
    family switches it on): train shape and decode, GQA 4q/2kv."""
    from llmtrain_tpu_torch.models.gpt import LayerKVCache

    jattn = JaxAttention(d_model=32, n_heads=4, n_layers=2, dropout=0.0, dtype=jnp.float32,
                         param_dtype=jnp.float32, attention=attention, n_kv_heads=2, rope=True)
    x = np.random.default_rng(6).standard_normal((2, 10, 32)).astype(np.float32)
    params = random_params(jattn, jnp.asarray(x), seed=6)
    tattn = _port_attention_from(params, 2, attention=attention, rope=True)
    j = jax.jit(jattn.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t = tattn(to_torch(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)

    jdec = jattn.clone(decode=True, cache_len=12)
    cache = jax.tree.map(jnp.zeros_like, jdec.init(jax.random.key(0), jnp.asarray(x[:, :1]))["cache"])
    kv = LayerKVCache(torch.zeros(2, 12, 2, 8), torch.zeros(2, 12, 2, 8))
    step = jax.jit(lambda variables, chunk: jdec.apply(variables, chunk, mutable=["cache"]))
    for chunk in (x[:, :6], x[:, 6:7], x[:, 7:8]):
        j, mutated = step({"params": params, "cache": cache}, jnp.asarray(chunk))
        cache = mutated["cache"]
        with torch.no_grad():
            t = tattn(to_torch(chunk), cache=kv)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_bf16_compute_keeps_f32_layernorm_statistics() -> None:
    """bf16 compute over f32 params (the headline preset): the port rounds
    where flax does, so its bf16 logits stay within bf16 noise of JAX's —
    four bf16 ulps at the logits' largest magnitude (8 significant bits:
    an ulp at magnitude m is at most m * 2**-7)."""
    jm, params = jax_gpt(seed=7, dtype=jnp.bfloat16)
    tm = port_gpt(jm, params)
    tm.dtype = torch.bfloat16
    for module in tm.modules():
        if hasattr(module, "dtype") and module is not tm:
            module.dtype = torch.bfloat16
    ids = seeded_ids(8, (1, 16), TINY["vocab_size"])
    j = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        t = tm(to_torch(ids).long())
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), j, atol=4 * 2**-7 * np.abs(j).max(), rtol=0)


def test_unported_options_raise() -> None:
    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.models.gpt import GPTAdapter

    base = {
        "run": {"name": "t", "device": "cpu"},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 1,
                  "n_heads": 2, "d_ff": 64, "vocab_size": 17, "dropout": 0.0},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 1, "warmup_steps": 0},
    }
    # ring and ulysses were refused here until they were ported: with no
    # sequence axis they run blockwise attention, the dense model's logits.
    dense = GPTAdapter().build_model(RunConfig.model_validate(base))
    ids = to_torch(seeded_ids(3, (2, 16), 17)).long()
    for model_over in (
        {"attention": "ulysses"},
        {"attention": "ring"},
    ):
        cfg = RunConfig.model_validate({**base, "model": {**base["model"], **model_over}})
        model = GPTAdapter().build_model(cfg)
        model.load_state_dict(dense.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(model(ids).numpy(), dense(ids).numpy(), atol=2e-5)
        windowed = {**base["model"], **model_over, "extra": {"sliding_window": 4}}
        with pytest.raises(ValueError, match="sliding_window is not supported"):
            GPTAdapter().build_model(RunConfig.model_validate({**base, "model": windowed}))
    # Quantized training matmuls were refused here until they were ported.
    cfg = RunConfig.model_validate(
        {**base, "model": {**base["model"], "extra": {"matmul_precision": "int8"}}})
    assert GPTAdapter().build_model(cfg).matmul_precision == "int8"
