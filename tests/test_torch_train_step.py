"""The port's loss, gradients and train step against the JAX package's.

A 2-layer GPT carries the same weights into both packages
(interop/flax_params.py); batches are seeded numpy. Bands (ROADMAP.md's
parity bands): loss and gradients atol 1e-5, rtol 1e-4 (f32, summation
order only), with ``fused_norm`` on (JAX's Pallas kernel in interpret
mode, the port's plain version) and off, and with the streamed losses
``fused_ce`` (JAX's Pallas kernels in interpret mode, the port's plain
versions) and ``chunked_ce``, tied and untied, at a vocab (61) that is
not a multiple of their tiles; one AdamW step with ``fused_ce``; the
optimizer trajectory over 4
AdamW steps with clipping and the warmup-cosine schedule, against JAX's
``make_train_step`` with optax, atol 3e-5, rtol 1e-3. Gradients map to
the port's parameter names through the same carry-over function as the
weights (it only reshapes and transposes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_port_helpers import TINY, jax_gpt, port_gpt, seeded_ids

from llmtrain_tpu.config.schemas import TrainerConfig as JaxTrainerConfig
from llmtrain_tpu.models.gpt import GPTAdapter as JaxGPTAdapter
from llmtrain_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from llmtrain_tpu.training.train_step import TrainState as JaxTrainState
from llmtrain_tpu.training.train_step import make_train_step as jax_make_train_step
from llmtrain_tpu_torch.config.schemas import TrainerConfig
from llmtrain_tpu_torch.interop import flax_gpt_params_to_state_dict
from llmtrain_tpu_torch.models.gpt import GPTAdapter
from llmtrain_tpu_torch.training.optimizer import AdamW, lr_schedule
from llmtrain_tpu_torch.training.train_step import TrainState, make_train_step

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
TRAINER = dict(max_steps=6, lr=1e-3, warmup_steps=2, weight_decay=0.1, max_grad_norm=0.5)


def _batch(seed: int, shape: tuple[int, ...], masked: bool) -> dict[str, np.ndarray]:
    ids = seeded_ids(seed, shape, TINY["vocab_size"])
    labels = seeded_ids(seed + 1, shape, TINY["vocab_size"])
    mask = np.ones(shape, np.int32)
    if masked:
        mask[..., -5:] = 0  # padded tail
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


def _port_model(jm, params, fused_norm: bool = False):
    """The port's GPT with the JAX model's weights, fused-norm flag and
    loss knobs."""
    tm = port_gpt(jm, params)
    tm.fused_norm = fused_norm
    for block in tm.blocks:
        block.fused_norm = fused_norm
    for knob in _LOSS_KNOBS:
        setattr(tm, knob, getattr(jm, knob))
    return tm


def _torch_batch(batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# Streamed-loss knobs: tiles that do not divide the vocab (61) or the
# tokens (2 x 24).
FUSED_CE = dict(loss_impl="fused_ce", fused_ce_block_t=16, fused_ce_block_v=16,
                pallas_interpret=True)
CHUNKED_CE = dict(loss_impl="chunked_ce", ce_chunk=16)
_LOSS_KNOBS = ("loss_impl", "z_loss", "fused_ce_block_t", "fused_ce_block_v", "ce_chunk")


@pytest.mark.parametrize(
    "fused_norm, extra",
    [(False, {}), (True, {}), (False, dict(z_loss=1e-3, n_kv_heads=2, tie_embeddings=False)),
     (False, FUSED_CE), (False, dict(FUSED_CE, z_loss=1e-3, tie_embeddings=False)),
     (False, CHUNKED_CE), (False, dict(CHUNKED_CE, z_loss=1e-3, tie_embeddings=False))],
    ids=["unfused", "fused_norm", "zloss-gqa-untied", "fused_ce-tied", "fused_ce-zloss-untied",
         "chunked_ce-tied", "chunked_ce-zloss-untied"],
)
def test_loss_and_grads_match_jax(fused_norm: bool, extra: dict) -> None:
    """Through the whole model with a padded tail: the segment mask reaches
    the attention (no assume_packed) and the output mask zeroes the padded
    rows, whose cotangent the backward must then ignore."""
    extra = {"pallas_interpret": fused_norm, **extra}
    jm, params = jax_gpt(seed=5, attention="flash", fused_norm=fused_norm, **extra)
    batch = _batch(6, (2, 24), masked=True)

    def jax_loss(p):
        loss_sum, tokens = JaxGPTAdapter().compute_loss_components(
            jm, p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.sum(loss_sum) / jnp.maximum(jnp.sum(tokens), 1.0)

    j_loss, j_grads = jax.value_and_grad(jax_loss)(params)
    tm = _port_model(jm, params, fused_norm)
    loss_sum, tokens = GPTAdapter().compute_loss_components(tm, _torch_batch(batch))
    loss = loss_sum.sum() / tokens.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    expected = flax_gpt_params_to_state_dict(serialization.to_state_dict(j_grads))
    named = dict(tm.named_parameters())
    assert set(expected) == set(named)
    for name, g in expected.items():
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(g), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_adamw_trajectory_matches_optax() -> None:
    """4 steps, 2 micro-batches each, clipping active (max_grad_norm 0.5),
    the warmup-cosine schedule crossing its boundary."""
    jm, params = jax_gpt(seed=7, attention="dense")
    tm = port_gpt(jm, params)
    jax_cfg = JaxTrainerConfig(**TRAINER)
    tx = jax_build_optimizer(jax_cfg)
    j_step = jax.jit(jax_make_train_step(JaxGPTAdapter(), jm, tx, grad_accum_steps=2,
                                         use_dropout=False))
    j_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    optimizer = AdamW(list(tm.named_parameters()), TrainerConfig(**TRAINER))
    state = TrainState(step=0, model=tm, optimizer=optimizer)
    step_fn = make_train_step(GPTAdapter(), tm, grad_accum_steps=2, use_dropout=False, seed=0)
    for i in range(4):
        batch = _batch(20 + i, (2, 2, 16), masked=False)
        j_state, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.key(0))
        metrics = step_fn(state, _torch_batch(batch))
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]),
                                   atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                   atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    assert state.step == int(j_state.step) == 4 and optimizer.count == 4
    lr_sum = sum(lr_schedule(TrainerConfig(**TRAINER))(c) for c in range(4))
    _assert_params_match(tm, j_state.params, lr_sum)


def test_adamw_step_with_fused_ce_matches_optax() -> None:
    """One optimizer step (2 micro-batches, clipping, no warmup) with the
    loss through the fused lm-head CE: JAX's Pallas kernels in interpret
    mode, the port's plain versions."""
    trainer = {**TRAINER, "warmup_steps": 0}
    jm, params = jax_gpt(seed=8, attention="flash", **FUSED_CE)
    tm = _port_model(jm, params)
    tx = jax_build_optimizer(JaxTrainerConfig(**trainer))
    j_step = jax.jit(jax_make_train_step(JaxGPTAdapter(), jm, tx, grad_accum_steps=2,
                                         use_dropout=False))
    j_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    state = TrainState(step=0, model=tm, optimizer=AdamW(list(tm.named_parameters()),
                                                         TrainerConfig(**trainer)))
    step_fn = make_train_step(GPTAdapter(), tm, grad_accum_steps=2, use_dropout=False, seed=0)
    batch = _batch(25, (2, 2, 16), masked=False)
    j_state, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(0))
    metrics = step_fn(state, _torch_batch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[key].item(), float(j_metrics[key]), atol=TRAJ_ATOL,
                                   rtol=TRAJ_RTOL)
    _assert_params_match(tm, j_state.params, lr_schedule(TrainerConfig(**trainer))(0))


def _assert_params_match(tm, j_params, lr_sum: float) -> None:
    expected = flax_gpt_params_to_state_dict(serialization.to_state_dict(j_params))
    d = TINY["d_model"]
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), np.asarray(expected[name])
        if name.endswith("qkv_proj.bias"):
            # The key bias shifts every score of a softmax row by the same
            # amount, so its gradient is rounding noise on both sides and
            # Adam's normalisation turns that noise into steps of up to lr
            # of either sign: bounded by the summed lr, not by the band.
            key = slice(d, 2 * d)
            np.testing.assert_array_less(np.abs(got[key] - want[key]), 2 * lr_sum)
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, atol=TRAJ_ATOL, rtol=TRAJ_RTOL, err_msg=name)


def test_lr_schedule_matches_jax() -> None:
    from llmtrain_tpu.training.optimizer import lr_schedule as jax_lr_schedule

    for kw in (TRAINER, dict(max_steps=10, lr=6e-4, warmup_steps=10), dict(max_steps=9, lr=1e-3,
                                                                            warmup_steps=0)):
        ours, theirs = lr_schedule(TrainerConfig(**kw)), jax_lr_schedule(JaxTrainerConfig(**kw))
        for count in range(kw["max_steps"] + 2):
            assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6, abs=1e-12)


def test_grad_accumulation_equals_one_large_batch() -> None:
    jm, params = jax_gpt(seed=9, attention="flash")
    batch = _batch(30, (2, 2, 16), masked=False)
    finals = []
    for accum, shape in ((2, (2, 2, 16)), (1, (1, 4, 16))):
        tm = port_gpt(jm, params)
        state = TrainState(step=0, model=tm,
                           optimizer=AdamW(list(tm.named_parameters()), TrainerConfig(**TRAINER)))
        step_fn = make_train_step(GPTAdapter(), tm, grad_accum_steps=accum, use_dropout=False,
                                  seed=0)
        metrics = step_fn(state, _torch_batch({k: v.reshape(shape) for k, v in batch.items()}))
        finals.append((metrics["loss"].item(), [p.detach().clone() for p in tm.parameters()]))
    (loss_a, params_a), (loss_b, params_b) = finals
    assert loss_a == pytest.approx(loss_b, rel=1e-6)
    for a, b in zip(params_a, params_b):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_nonfinite_step_is_skipped_and_counted() -> None:
    jm, params = jax_gpt(seed=11, attention="flash")
    tm = port_gpt(jm, params)
    # No warmup: the first applied update has a nonzero learning rate.
    optimizer = AdamW(list(tm.named_parameters()), TrainerConfig(**{**TRAINER, "warmup_steps": 0}))
    state = TrainState(step=0, model=tm, optimizer=optimizer, nonfinite_count=0)

    class PoisonedAdapter(GPTAdapter):
        poison = True

        def compute_loss_components(self, model, batch, **kw):
            loss_sum, tokens = super().compute_loss_components(model, batch, **kw)
            return (loss_sum * float("nan") if self.poison else loss_sum), tokens

    adapter = PoisonedAdapter()
    step_fn = make_train_step(adapter, tm, grad_accum_steps=1, use_dropout=False, seed=0,
                              nonfinite_guard=True)
    before = [p.detach().clone() for p in tm.parameters()]
    batch = _torch_batch(_batch(40, (1, 2, 16), masked=False))
    metrics = step_fn(state, batch)
    assert not np.isfinite(metrics["loss"].item())
    assert state.step == 1 and state.nonfinite_count == 1 and optimizer.count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    assert all(torch.count_nonzero(m) == 0 for m in optimizer.mu)
    adapter.poison = False
    step_fn(state, batch)
    assert state.step == 2 and state.nonfinite_count == 0 and optimizer.count == 1
    assert not all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))


def test_dropout_draws_from_the_generator_and_is_off_when_deterministic() -> None:
    from llmtrain_tpu_torch.training.train_step import dropout_generator

    jm, params = jax_gpt(seed=12, attention="dense")
    tm = port_gpt(jm, params)
    tm.dropout = 0.3
    for block in tm.blocks:
        block.dropout = block.attn.dropout = 0.3
    ids = torch.from_numpy(seeded_ids(41, (2, 16), TINY["vocab_size"])).long()
    with torch.no_grad():
        plain = tm(ids)
        a = tm(ids, deterministic=False, generator=dropout_generator(1, 3, 0, ids.device))
        b = tm(ids, deterministic=False, generator=dropout_generator(1, 3, 0, ids.device))
        c = tm(ids, deterministic=False, generator=dropout_generator(1, 4, 0, ids.device))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="Generator"):
        tm(ids, deterministic=False)


def test_loss_impl_resolves_as_in_jax_and_streamed_losses_raise() -> None:
    """Resolution as in JAX; the streamed losses (``fused_ce``,
    ``chunked_ce``) now run and equal the dense loss and its gradients;
    what still raises is a ``loss_impl`` outside the three, whether in
    the config or set on a built model."""
    from llmtrain_tpu.ops.fused_ce import resolve_loss_impl as jax_resolve
    from llmtrain_tpu_torch.models.gpt import resolve_loss_impl

    for requested, vocab in ((None, 256), (None, 50304), ("dense", 50304), ("chunked_ce", 256)):
        ours = resolve_loss_impl(requested, vocab_size=vocab, ce_auto_vocab=32768)
        theirs = jax_resolve(requested, vocab_size=vocab, ce_auto_vocab=32768, interpret=True)
        assert ours == theirs, (requested, vocab)
    with pytest.raises(ValueError, match="unknown"):
        resolve_loss_impl("sparse_ce", vocab_size=256, ce_auto_vocab=32768)
    jm, params = jax_gpt(seed=13)
    batch = _torch_batch(_batch(50, (2, 12), masked=True))
    results = {}
    for impl in ("dense", "fused_ce", "chunked_ce"):
        tm = port_gpt(jm, params)
        tm.loss_impl, tm.fused_ce_block_v, tm.ce_chunk = impl, 16, 16
        loss_sum, tokens = GPTAdapter().compute_loss_components(tm, batch)
        (loss_sum.sum() / tokens.sum()).backward()
        results[impl] = (loss_sum.detach(), tokens, [p.grad for p in tm.parameters()])
    dense_sum, dense_tokens, dense_grads = results.pop("dense")
    for impl, (loss_sum, tokens, grads) in results.items():
        torch.testing.assert_close(loss_sum, dense_sum, atol=2e-5, rtol=1e-5, msg=impl)
        assert torch.equal(tokens, dense_tokens)
        for g, dg in zip(grads, dense_grads):
            torch.testing.assert_close(g, dg, atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=impl)
    tm.loss_impl = "sparse_ce"
    with pytest.raises(ValueError, match="unknown"):
        GPTAdapter().compute_loss_components(tm, batch)
