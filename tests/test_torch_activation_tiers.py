"""Activation tiers and remat in the port (models/activation_policy.py) on
the CPU.

* Every ladder (``full``, ``selective``, ``offload``, mixed, the legacy
  ``dots_no_batch`` remat) gives the loss and the gradients of ``none``
  bit for bit: GPT with dropout on dense attention (the recompute replays
  the explicit generator's masks), with ``fused_norm``, the llama family
  and the MoE layout (its load-balance loss through the checkpoint).
  ``offload`` is built directly here: on the CPU the config resolves it
  to ``full``, but its host copy and recompute run on any device.
* The tiered port against the tiered JAX GPT, the weights carried over
  (logits atol/rtol 2e-5, gradients atol 1e-5 and rtol 1e-4).
* ``resolve_config_activation_tiers`` against JAX's: the explicit spec,
  the ``model.remat`` migrations (``nothing`` -> full, ``dots`` ->
  selective, ``dots_no_batch`` stays legacy) and the conflict error.
* The offload resolution on the CPU: ``offload`` -> ``full`` with one
  warning (JAX's CPU backend here has a ``pinned_host`` space and keeps
  it; the port's CPU has no pinned memory to stage to).
"""

from __future__ import annotations

import logging
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_port_helpers import jax_gpt, seeded_ids

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.models.gpt import resolve_config_activation_tiers as jax_resolve
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict
from llmtrain_tpu_torch.models import activation_policy
from llmtrain_tpu_torch.models.gpt import GPT, GPTAdapter, resolve_config_activation_tiers
from llmtrain_tpu_torch.models.llama import Llama

LADDERS = {
    "full": ("full",) * 3,
    "selective": ("selective",) * 3,
    "offload": ("offload",) * 3,
    "mixed": ("offload", "selective", "full"),
    "dots_no_batch": ("dots_no_batch",) * 3,
}


class _Staged:
    """The host copies the offload tier makes (``activation_policy.host_copy``,
    wrapped): the bytes alive now and the most alive at once."""

    def __init__(self, monkeypatch) -> None:
        self.refs: list[tuple[weakref.ref, int]] = []
        self.peak = 0
        real = activation_policy.host_copy

        def staging(t: torch.Tensor) -> torch.Tensor:
            host = real(t)
            self.refs.append((weakref.ref(host), host.numel() * host.element_size()))
            self.peak = max(self.peak, self.live)
            return host

        monkeypatch.setattr(activation_policy, "host_copy", staging)

    @property
    def live(self) -> int:
        return sum(n for ref, n in self.refs if ref() is not None)


def _gpt(model_cls=GPT, **kw) -> torch.nn.Module:
    args = dict(vocab_size=61, block_size=16, d_model=32, n_layers=3, n_heads=2, d_ff=64,
                attention="dense", dropout=0.1)
    model = model_cls(**{**args, **kw})
    model.init_weights(torch.Generator().manual_seed(1))
    return model


def _loss_and_grads(model) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    from llmtrain_tpu_torch.models.moe import take_aux_loss

    ids = torch.from_numpy(seeded_ids(2, (2, 16), 61)).long()
    gen = torch.Generator().manual_seed(5)
    loss = model(ids, deterministic=False, generator=gen).float().pow(2).mean()
    aux = take_aux_loss(model)
    if aux is not None:
        loss = loss + aux
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


FAMILIES = {
    "gpt": dict(),
    "gpt-fused-norm": dict(fused_norm=True, dropout=0.0),
    "llama": dict(model_cls=Llama, rope_theta=10000.0),
    "gpt-moe": dict(moe=dict(n_experts=4, router_top_k=2, capacity_factor=2.0)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_every_ladder_is_bitwise_none(family: str, ladder: str, monkeypatch) -> None:
    staged = _Staged(monkeypatch)
    kw = FAMILIES[family]
    loss0, grads0 = _loss_and_grads(_gpt(**kw))
    model = _gpt(activation_tiers=LADDERS[ladder], **kw)
    assert model.layer_tiers == LADDERS[ladder]
    loss, grads = _loss_and_grads(model)
    assert torch.equal(loss, loss0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name
    assert len(staged.refs) == ladder_offloads(ladder)
    assert staged.live == 0  # every staged input came back and was freed


def ladder_offloads(ladder: str) -> int:
    return sum(t == "offload" for t in LADDERS[ladder])


def test_offload_stages_the_block_inputs_on_the_host(monkeypatch) -> None:
    staged = _Staged(monkeypatch)
    model = _gpt(activation_tiers=LADDERS["mixed"], dropout=0.0)
    _loss_and_grads(model)
    # One (2, 16, 32) f32 input staged at a time, none left after backward.
    assert (staged.live, staged.peak) == (0, 2 * 16 * 32 * 4)


@pytest.mark.parametrize("tiers", [("full", "selective"), ("none", "full")])
def test_tiered_port_matches_tiered_jax(tiers) -> None:
    jm, params = jax_gpt(seed=4, attention="dense", activation_tiers=tiers)
    ids = seeded_ids(7, (2, 16), jm.vocab_size)
    cot = np.random.default_rng(8).normal(size=(2, 16, jm.vocab_size)).astype(np.float32)

    def jax_loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(ids)) * cot)

    j_logits = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(ids)))
    j_grads = jax.jit(jax.grad(jax_loss))(params)
    tm = GPT(vocab_size=jm.vocab_size, block_size=jm.block_size, d_model=jm.d_model,
             n_layers=jm.n_layers, n_heads=jm.n_heads, d_ff=jm.d_ff, attention="dense",
             activation_tiers=tiers)
    tm.load_state_dict(flax_gpt_params_to_state_dict(serialization.to_state_dict(params)))
    logits = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, atol=2e-5, rtol=2e-5)
    (logits * torch.from_numpy(cot)).sum().backward()
    expected = flax_gpt_params_to_state_dict(serialization.to_state_dict(j_grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(expected[name]), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def _raw(remat: bool = False, **extra) -> dict:
    return {
        "run": {"name": "t", "device": "cpu"},
        "model": {"name": "gpt", "block_size": 8, "d_model": 32, "n_layers": 4, "n_heads": 2,
                  "d_ff": 64, "vocab_size": 64, "remat": remat, "extra": extra},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 1, "warmup_steps": 0},
    }


@pytest.mark.parametrize("case", [
    dict(), dict(remat=True), dict(remat=True, remat_policy="dots"),
    dict(remat=True, remat_policy="dots_no_batch"), dict(activation_tiers="full:0-1,selective:2-3"),
    dict(activation_tiers="none:0,full:1-3"),
], ids=["off", "remat", "remat-dots", "remat-dots-no-batch", "tiers", "tiers-none"])
def test_config_resolution_matches_jax(case: dict) -> None:
    raw = _raw(**case)
    want = jax_resolve(JaxRunConfig.model_validate(raw))
    assert resolve_config_activation_tiers(RunConfig.model_validate(raw)) == want
    model = GPTAdapter().build_model(RunConfig.model_validate(raw))
    legacy = {"dots_no_batch": ("dots_no_batch",) * 4}.get(case.get("remat_policy"))
    assert model.layer_tiers == (want or legacy or ("none",) * 4)


def test_remat_with_tiers_is_a_config_error_in_both() -> None:
    raw = _raw(remat=True, activation_tiers="full:*")
    for schema in (RunConfig, JaxRunConfig):
        with pytest.raises(ValueError, match="conflicts"):
            schema.model_validate(raw)
    with pytest.raises(ValueError, match="remat_policy"):
        GPTAdapter().build_model(RunConfig.model_validate(_raw(remat_policy="nothin")))


def test_offload_resolves_to_full_on_the_cpu_with_one_warning(monkeypatch, caplog) -> None:
    monkeypatch.setattr(activation_policy, "_FALLBACK_WARNED", set())
    logger = logging.getLogger("llmtrain")
    propagate, logger.propagate = logger.propagate, True
    caplog.set_level(logging.WARNING, logger="llmtrain")
    try:
        raw = _raw(activation_tiers="offload:0-1,full:2-3")
        tiers = resolve_config_activation_tiers(RunConfig.model_validate(raw))
        model = GPTAdapter().build_model(RunConfig.model_validate(raw))
    finally:
        logger.propagate = propagate
    assert tiers == ("full",) * 4 and model.layer_tiers == tiers
    assert sum("falling back offload -> full" in r.getMessage() for r in caplog.records) == 1
    assert not activation_policy.offload_supported("cpu")
    assert activation_policy.resolve_activation_tiers(("offload",), "cpu") == ("full",)
