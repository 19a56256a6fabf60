"""The training and eval steps (port of ``llmtrain_tpu/training/train_step.py``).

JAX traces one XLA program per optimizer step; the port runs the same
step eagerly:

* gradient accumulation over the leading micro-batch axis of the batch
  ``(A, B, T)``: each micro-batch's token-weighted mean loss is
  back-propagated into ``.grad`` (summing), and the sum is divided by A;
* the global gradient norm (before clipping) comes back as a metric;
* dropout draws from a ``torch.Generator`` seeded by ``(seed, step,
  micro-batch)``, so resume reproduces the stream without saving
  generator state (JAX folds the same pair into its run key; the two
  frameworks draw different bits from the same seed);
* ``nonfinite_guard``: a step whose loss or gradients are not all finite
  leaves the parameters and optimizer state as they were, still advances
  ``step`` (the sampler moves past the bad batch), and bumps the
  consecutive-skip counter the trainer aborts on.

Metrics stay device tensors; the trainer reads them at log boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..models.base import ModelAdapter
from .optimizer import AdamW, global_norm


@dataclass
class TrainState:
    """What the step updates: ``step`` counts completed optimizer steps
    (0 = fresh init), the model holds the parameters, the optimizer its
    state; ``nonfinite_count`` is the guard's consecutive-skip counter
    (None when the guard is off)."""

    step: int
    model: torch.nn.Module
    optimizer: AdamW
    nonfinite_count: int | None = None


def dropout_generator(seed: int, step: int, micro: int, device: torch.device) -> torch.Generator:
    """The dropout stream of micro-batch ``micro`` of optimizer step
    ``step`` (0-based count of completed steps), a pure function of the
    three."""
    entropy = np.random.SeedSequence([seed & 0xFFFFFFFF, step, micro]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(entropy))


def make_loss_fn(adapter: ModelAdapter, model: torch.nn.Module, *, use_dropout: bool) -> Callable:
    """Per-micro-batch loss: (batch, generator) -> (loss, (loss_sum_B, tokens_B))."""

    def loss_fn(micro_batch: dict, generator: torch.Generator | None):
        comps = adapter.compute_loss_components(
            model, micro_batch, generator=generator, deterministic=not use_dropout
        )
        if comps is None:
            loss, _ = adapter.compute_loss(
                model, micro_batch, generator=generator, deterministic=not use_dropout
            )
            mask = micro_batch.get("attention_mask")
            ids = micro_batch["input_ids"]
            if mask is None:
                tokens = torch.full((ids.shape[0],), float(ids.shape[1]), device=ids.device)
            else:
                tokens = (mask != 0).float().sum(dim=-1)
            return loss, (loss.detach() * tokens, tokens)
        loss_sum, tokens = comps
        loss = loss_sum.sum() / tokens.sum().clamp_min(1.0)
        return loss, (loss_sum, tokens)

    return loss_fn


def make_train_step(
    adapter: ModelAdapter,
    model: torch.nn.Module,
    *,
    grad_accum_steps: int,
    use_dropout: bool,
    seed: int,
    nonfinite_guard: bool = False,
) -> Callable[[TrainState, dict], dict]:
    """The step: ``(state, batch(A, B, T)) -> metrics``, updating ``state``
    in place. Metrics: ``loss`` (mean over micro-batches of their
    token-weighted means), ``per_example_loss_sum`` and
    ``per_example_tokens`` (A, B), ``grad_norm``, and with the guard
    ``nonfinite_count``."""
    loss_fn = make_loss_fn(adapter, model, use_dropout=use_dropout)

    def train_step(state: TrainState, batch: dict) -> dict[str, Any]:
        params = state.optimizer.params
        for p in params:
            p.grad = None
        losses, loss_sums, token_counts = [], [], []
        for idx in range(grad_accum_steps):
            micro = {k: v[idx] for k, v in batch.items()}
            gen = None
            if use_dropout:
                gen = dropout_generator(seed, state.step, idx, params[0].device)
            loss, (loss_sum, tokens) = loss_fn(micro, gen)
            loss.backward()
            losses.append(loss.detach())
            loss_sums.append(loss_sum.detach())
            token_counts.append(tokens.detach())
        grads = [
            (p.grad if p.grad is not None else torch.zeros_like(p)) / grad_accum_steps
            for p in params
        ]
        for p in params:
            p.grad = None
        losses_t = torch.stack(losses)
        metrics: dict[str, Any] = {
            "loss": losses_t.mean(),
            "per_example_loss_sum": torch.stack(loss_sums),
            "per_example_tokens": torch.stack(token_counts),
            "grad_norm": global_norm(grads),
        }
        if nonfinite_guard:
            finite = bool(torch.isfinite(losses_t).all()) and all(
                bool(torch.isfinite(g).all()) for g in grads
            )
            if finite:
                state.optimizer.step(grads)
            state.nonfinite_count = 0 if finite else (state.nonfinite_count or 0) + 1
            metrics["nonfinite_count"] = state.nonfinite_count
        else:
            state.optimizer.step(grads)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(adapter: ModelAdapter, model: torch.nn.Module) -> Callable:
    """Forward only: batch(B, T) -> (loss_sum_B, tokens_B)."""
    loss_fn = make_loss_fn(adapter, model, use_dropout=False)

    @torch.no_grad()
    def eval_step(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        _, (loss_sum, tokens) = loss_fn(batch, None)
        return loss_sum, tokens

    return eval_step


__all__ = ["TrainState", "dropout_generator", "make_eval_step", "make_loss_fn", "make_train_step"]
