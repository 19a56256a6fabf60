"""The quantized training matmuls (``model.extra.matmul_precision``) of the
port (llmtrain_tpu_torch/ops/quant.py) against the JAX package's, on the CPU.

* ``fake_quant`` bit for bit JAX's on the same arrays, with the identity
  (straight-through) gradient; ``QuantLinear`` loads ``nn.Linear``'s
  parameters and its ``f32`` mode is ``F.linear``.
* The fp8 product: its forward against JAX's ``_fp8_dot`` (JAX's
  ``fp8_supported()`` is true on this CPU), the backward exactly the
  plain product's, the broken control (one scale dropped) far outside.
* The GPT's logits and gradients in ``int8``, ``int8_act`` and ``fp8``
  against the JAX GPT in the same mode, the weights carried over; ``f32``
  bitwise the build without the knob.
* Eight steps of each mode's loss within JAX's ``PARITY_RTOL`` of the f32
  trajectory (tests/test_quant_train.py), through the port's trainer.
* The MoE experts in int8 against JAX's ``MoEMLP`` in int8.

Bands: the North star's, logits atol/rtol 2e-5 and gradients atol 1e-5,
rtol 1e-4, in every mode (the int8 codes are JAX's bit for bit, the fp8
casts of these inputs too). The fp8 product alone is held to 1e-6 of its
largest output: the same exact e4m3 products, summed in another order.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization
from flax.linen import meta as nn_meta
from jax import lax
from torch_port_helpers import jax_gpt, seeded_ids

from llmtrain_tpu.models.moe import MoEMLP as JaxMoEMLP
from llmtrain_tpu.ops import quant as jquant
from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict
from llmtrain_tpu_torch.models.gpt import GPT
from llmtrain_tpu_torch.models.moe import MoEMLP
from llmtrain_tpu_torch.ops import quant

PARITY_RTOL = {"int8": 0.05, "int8_act": 0.05, "fp8": 0.10}  # tests/test_quant_train.py
LOGITS_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# The fp8 forward against JAX's: the same exact e4m3 products summed in f32
# in another order, relative to the output's largest magnitude.
FP8_DOT_RTOL = 1e-6


def _normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axes", [((8, 6), (0,)), ((5, 4, 3), (1, 2)), ((7, 16), (1,))])
def test_fake_quant_is_jax_bit_for_bit(shape, axes) -> None:
    w = _normal(sum(shape), shape)
    w[..., 0] = 0.0  # an all-zero channel in some layouts
    want = np.asarray(jquant.fake_quant(jnp.asarray(w), axes))
    t = torch.from_numpy(w.copy()).requires_grad_(True)
    got = quant.fake_quant(t, axes)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    cot = torch.from_numpy(_normal(3, shape))
    (got * cot).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), cot.numpy())  # straight through


def test_quant_linear_takes_linear_parameters() -> None:
    torch.manual_seed(0)
    dense = torch.nn.Linear(16, 8)
    x = torch.from_numpy(_normal(4, (4, 16)))
    q = quant.QuantLinear(16, 8, matmul_precision="int8")
    q.load_state_dict(dense.state_dict())
    f = quant.QuantLinear(16, 8, matmul_precision="f32")
    f.load_state_dict(dense.state_dict())
    assert torch.equal(f(x), dense(x))
    with torch.no_grad():
        rel = float((q(x) - dense(x)).abs().max() / dense(x).abs().max())
    assert 0.0 < rel < 0.05
    assert quant.quant_dot_general("f32") is None
    with pytest.raises(ValueError, match="int4"):
        quant.quant_dot_general("int4")
    with pytest.raises(ValueError, match="int4"):
        quant.resolve_matmul_precision("int4")


def test_fp8_resolution_and_fallback(monkeypatch, caplog) -> None:
    assert quant.fp8_supported("cpu") is True
    assert quant.resolve_matmul_precision("fp8", "cpu") == "fp8"
    monkeypatch.setattr(quant, "fp8_supported", lambda device=None: False)
    monkeypatch.setattr(quant, "_FALLBACK_WARNED", set())
    import logging

    logger = logging.getLogger("llmtrain")
    propagate, logger.propagate = logger.propagate, True
    caplog.set_level(logging.WARNING, logger="llmtrain")
    try:
        assert quant.resolve_matmul_precision("fp8") == "f32"
        assert quant.resolve_matmul_precision("fp8") == "f32"
    finally:
        logger.propagate = propagate
    assert sum("falling back to f32" in r.getMessage() for r in caplog.records) == 1


@pytest.mark.parametrize("m,k,n", [(6, 16, 8), (33, 70, 17)])
def test_fp8_dot_forward_matches_jax_and_backward_is_exact(m, k, n) -> None:
    a, b = _normal(10 + m, (m, k)), _normal(20 + n, (k, n), 0.3)
    dn = (((1,), (0,)), ((), ()))
    want = np.asarray(jquant._fp8_dot(jnp.asarray(a), jnp.asarray(b), dn))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = quant.fp8_dot(ta[None], tb[None])[0]
    scale = float(np.abs(want).max())
    assert float(np.abs(got.detach().numpy() - want).max()) <= FP8_DOT_RTOL * scale
    # Broken control: one of the two scales dropped.
    a8, b8, sa, _ = quant._fp8_operands(ta.detach()[None], tb.detach()[None])
    broken = (torch.bmm(a8.float(), b8.float()) * sa)[0]
    assert float((broken - got).abs().max()) > 100 * FP8_DOT_RTOL * scale
    # The backward: the plain product's gradients, bit for bit.
    cot = torch.from_numpy(_normal(5, (m, n)))
    (got * cot).sum().backward()
    pa, pb = ta.detach().clone().requires_grad_(True), tb.detach().clone().requires_grad_(True)
    (torch.bmm(pa[None], pb[None])[0] * cot).sum().backward()
    assert torch.equal(ta.grad, pa.grad) and torch.equal(tb.grad, pb.grad)
    jga, jgb = jax.grad(lambda x, y: jnp.sum(jquant._fp8_dot(x, y, dn) * jnp.asarray(
        cot.numpy())), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), atol=1e-5, rtol=1e-5)


def _port(jm, params, mode: str) -> GPT:
    model = GPT(vocab_size=jm.vocab_size, block_size=jm.block_size, d_model=jm.d_model,
                n_layers=jm.n_layers, n_heads=jm.n_heads, d_ff=jm.d_ff,
                tie_embeddings=jm.tie_embeddings, attention=jm.attention,
                n_kv_heads=jm.n_kv_heads, matmul_precision=mode)
    model.load_state_dict(flax_gpt_params_to_state_dict(serialization.to_state_dict(params)))
    return model


@pytest.mark.parametrize("mode", ["int8", "int8_act", "fp8"])
def test_gpt_logits_and_grads_match_jax(mode: str) -> None:
    jm, params = jax_gpt(seed=3, attention="dense", n_kv_heads=2, matmul_precision=mode)
    ids = seeded_ids(4, (2, 16), jm.vocab_size)
    cot = _normal(6, (2, 16, jm.vocab_size), 0.1)

    def jax_loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(ids)) * cot)

    j_logits = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(ids)))
    j_grads = jax.jit(jax.grad(jax_loss))(params)
    tm = _port(jm, params, mode)
    logits = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    (logits * torch.from_numpy(cot)).sum().backward()
    expected = flax_gpt_params_to_state_dict(serialization.to_state_dict(j_grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(expected[name]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    # Quantized, so not the f32 logits.
    f32 = _port(jm, params, "f32")(torch.from_numpy(ids).long())
    assert not torch.equal(f32, logits)


def test_f32_is_bitwise_the_build_without_the_knob() -> None:
    jm, params = jax_gpt(seed=8, attention="dense")
    ids = torch.from_numpy(seeded_ids(9, (2, 16), jm.vocab_size)).long()
    outs = []
    for model in (_port(jm, params, "f32"), _port(jm, params, "f32")):
        if len(outs):  # the second: GPT's default, no matmul_precision given
            model = GPT(vocab_size=jm.vocab_size, block_size=jm.block_size, d_model=jm.d_model,
                        n_layers=jm.n_layers, n_heads=jm.n_heads, d_ff=jm.d_ff,
                        attention=jm.attention)
            model.load_state_dict(flax_gpt_params_to_state_dict(
                serialization.to_state_dict(params)))
        logits = model(ids)
        logits.float().pow(2).mean().backward()
        outs.append((logits.detach(), [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def _fit(tmp_path, mode: str | None, steps: int = 8) -> list[float]:
    from unittest import mock

    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.training.trainer import Trainer

    extra = {} if mode is None else {"matmul_precision": mode}
    cfg = RunConfig.model_validate({
        "run": {"name": "quant-test", "seed": 7, "device": "cpu"},
        "model": {"name": "gpt", "block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "vocab_size": 256, "extra": extra},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": steps, "micro_batch_size": 4, "grad_accum_steps": 1,
                    "lr": 3e-3, "warmup_steps": 0, "log_every_steps": 1,
                    "eval_every_steps": 1000},
        "telemetry": {"enabled": False},
        "mlflow": {"enabled": False},
    })
    losses: list[float] = []
    real = Trainer._log_train_interval

    def log(self, **kw):
        losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
        return real(self, **kw)

    with mock.patch.object(Trainer, "_log_train_interval", log):
        trainer = Trainer(cfg, None)
        assert trainer._precision_block()["matmul_precision"] == (mode or "f32")
        trainer.fit()
    return losses


def test_n_step_loss_parity_against_f32(tmp_path) -> None:
    ref = _fit(tmp_path, "f32")
    assert ref == _fit(tmp_path, None)  # the f32 knob is the no-knob run, bit for bit
    for mode in ("int8", "int8_act", "fp8"):
        got = _fit(tmp_path, mode)
        assert all(math.isfinite(x) for x in got) and got != ref
        max_rel = max(abs(q - f) / max(abs(f), 1e-6) for q, f in zip(got, ref))
        assert max_rel < PARITY_RTOL[mode], f"{mode} drifted {max_rel:.4f}"


@pytest.mark.parametrize("mlp_type", ["gelu", "swiglu"])
def test_moe_experts_in_int8_match_jax(mlp_type: str) -> None:
    d, dff, e = 16, 32, 4
    jmod = JaxMoEMLP(d_model=d, d_ff=dff, n_experts=e, n_layers=2, router_top_k=2,
                     capacity_factor=2.0, mlp_type=mlp_type, matmul_precision="int8")
    x = _normal(11, (2, 8, d))
    params = nn_meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(12)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.2).astype(np.float32), params)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    tmod = MoEMLP(d, dff, e, dtype=torch.float32, param_dtype=torch.float32,
                  capacity_factor=2.0, router_top_k=2, mlp_type=mlp_type,
                  matmul_precision="int8")
    with torch.no_grad():
        tmod.router.weight.copy_(torch.from_numpy(np.asarray(params["router"]["kernel"]).T))
        for name, value in params.items():
            if name != "router":
                getattr(tmod, name).copy_(torch.from_numpy(np.asarray(value)))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    f32 = MoEMLP(d, dff, e, dtype=torch.float32, param_dtype=torch.float32,
                 capacity_factor=2.0, router_top_k=2, mlp_type=mlp_type)
    f32.load_state_dict(tmod.state_dict())
    assert not np.array_equal(f32(torch.from_numpy(x)).detach().numpy(), got)


def test_linear_modes_against_the_plain_products() -> None:
    """The mode's linear is the plain product of the quantized operands."""
    x = torch.from_numpy(_normal(30, (3, 5, 16)))
    w = torch.from_numpy(_normal(31, (8, 16)))
    bias = torch.from_numpy(_normal(32, (8,)))
    int8 = quant.quant_dot_general("int8")(x, w, bias)
    assert torch.equal(int8, F.linear(x, quant.quantize_array(w, reduce_axes=(1,)).dequantize(),
                                      bias))
    act = quant.quant_dot_general("int8_act")(x, w, bias)
    xq = quant.quantize_array(x, reduce_axes=(2,)).dequantize()
    assert torch.equal(act, F.linear(xq, quant.quantize_array(w, reduce_axes=(1,)).dequantize(),
                                     bias))
    fp8 = quant.quant_dot_general("fp8")(x, w, bias)
    plain = quant.fp8_bmm_plain(x.reshape(1, 15, 16), w.t()[None]).reshape(3, 5, 8) + bias
    assert torch.equal(fp8, plain)
    ref = lax.dot_general(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T),
                          (((2,), (0,)), ((), ())))
    rel = float(np.abs(fp8.numpy() - bias.numpy() - np.asarray(ref)).max()
                / np.abs(np.asarray(ref)).max())
    assert rel < 0.10


@pytest.mark.parametrize("name", ["llama", "llama_moe"])
def test_llama_family_takes_the_knob(name: str) -> None:
    """JAX's ``LlamaBlock`` builds its projections and experts without the
    knob (a recorded divergence): the port quantizes the family as GPT."""
    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.models.lora import build_adapter

    def build(mode: str):
        extra = {"matmul_precision": mode, "n_kv_heads": 2}
        if name == "llama_moe":
            extra.update(n_experts=4, router_top_k=2)
        cfg = RunConfig.model_validate({
            "run": {"name": "t", "device": "cpu"},
            "model": {"name": name, "block_size": 16, "d_model": 32, "n_layers": 2,
                      "n_heads": 4, "d_ff": 64, "vocab_size": 61, "dropout": 0.0,
                      "extra": extra},
            "data": {"name": "dummy_text"},
            "trainer": {"max_steps": 1, "warmup_steps": 0},
        })
        return build_adapter(cfg).build_model(cfg)

    quantized, plain = build("int8"), build("f32")
    assert all(b.attn.matmul_precision == "int8" for b in quantized.blocks)
    ids = torch.from_numpy(seeded_ids(13, (2, 16), 61)).long()
    with torch.no_grad():
        got, want = quantized(ids), plain(ids)
    rel = float((got - want).abs().max() / want.abs().max())
    assert 0.0 < rel < 0.05
