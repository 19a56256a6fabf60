"""The training and eval steps (port of ``llmtrain_tpu/training/train_step.py``).

JAX traces one XLA program per optimizer step; the port runs the same
step eagerly:

* gradient accumulation over the leading micro-batch axis of the batch
  ``(A, B, T)``: each micro-batch's token-weighted mean loss is
  back-propagated into ``.grad`` (summing), and the sum is divided by A;
* the global gradient norm (before clipping) comes back as a metric;
* data parallel (``data_parallel``, one process per device in a
  ``torch.distributed`` group): the loss is JAX's token-weighted mean over
  the **global** micro-batch, so rank r back-propagates ``loss_sum_r /
  tokens_global`` (the token counts are summed over the ranks after each
  forward) and the accumulated gradients, with the step's losses, are
  summed over the ranks once per step, one all-reduce over a flat buffer
  per dtype, before the norm, the clip and the guard, so every rank makes
  the same decision. With one rank the arithmetic is that of the
  single-process step, all-reduce included;
* dropout draws from a ``torch.Generator`` seeded by ``(seed, step,
  micro-batch)``, with the rank folded in past rank 0 and the spike
  rollbacks so far after any, so resume reproduces the stream without
  saving generator state, ranks do not share masks, and replayed steps
  draw fresh streams (JAX folds the same pair, and the rollback count,
  into its run key; the two frameworks draw different bits from the same
  seed);
* ``nonfinite_guard``: one flag on the device over the loss and every
  gradient (``resilience/guard.py``); the optimizer applies the update
  under it (``training/optimizer.py``), so a step whose loss or gradients
  are not all finite leaves the parameters and optimizer state as they
  were with no host read in the step, still advances ``step`` (the
  sampler moves past the bad batch), and bumps the device-side
  consecutive-skip counter the trainer reads at log boundaries;
* ``inject_nan_window=(first, n)`` (``resilience.faults.nan_loss_at_step``)
  poisons the loss and the gradients of optimizer steps ``first ..
  first+n-1`` with NaN inside the step, so the guard's recovery runs on
  the real path.

Metrics stay device tensors; the trainer reads them at log boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..models.base import ModelAdapter
from .optimizer import _Optimizer, global_norm


@dataclass
class TrainState:
    """What the step updates: ``step`` counts completed optimizer steps
    (0 = fresh init), the model holds the parameters, the optimizer its
    state; ``nonfinite_count`` is the guard's consecutive-skip counter
    (None when the guard is off)."""

    step: int
    model: torch.nn.Module
    optimizer: _Optimizer
    nonfinite_count: torch.Tensor | None = None


def dropout_generator(seed: int, step: int, micro: int, device: torch.device,
                      rank: int = 0, rollbacks: int = 0) -> torch.Generator:
    """The dropout stream of micro-batch ``micro`` of optimizer step
    ``step`` (0-based count of completed steps) on data-parallel rank
    ``rank`` after ``rollbacks`` spike rollbacks, a pure function of the
    five (rank 0's with no rollback is the one-process stream; a rollback
    count appends the rank too, so no two tuples coincide)."""
    keys = [seed & 0xFFFFFFFF, step, micro] + ([rank] if rank or rollbacks else [])
    keys += [rollbacks] if rollbacks else []
    entropy = np.random.SeedSequence(keys).generate_state(1)[0]
    if device.type == "meta":
        # The cost count (telemetry/profiling.py): a meta draw reads no
        # generator state, but torch has no meta generator to pass.
        device = torch.device("cpu")
    return torch.Generator(device=device).manual_seed(int(entropy))


def grad_reduce_op(backend: str):
    """The reduce op of the gradient sum over ``backend``'s group: SUM, or
    over NCCL a sum pre-multiplied by 1.0 (exact, so the same sums). The
    one reason for the NCCL op is that NCCL launches nothing for a one-rank
    in-place SUM, and a one-rank job on one card must still put the
    reduction's kernel in its profiler trace, which the card's smoke run
    checks. It goes through torch's private ``_make_nccl_premul_sum``;
    against SUM on several cards it is not yet measured."""
    import torch.distributed as dist

    return dist._make_nccl_premul_sum(1.0) if backend == "nccl" else dist.ReduceOp.SUM


def all_reduce_coalesced(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum ``tensors`` over the process group: one all-reduce over a flat
    buffer per dtype. Returns the reduced tensors (views of the buffers)."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from ..distributed import collective_errors

    op = grad_reduce_op(dist.get_backend())
    out: list[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        group = [tensors[i] for i in idx]
        flat = _flatten_dense_tensors(group)
        with collective_errors():
            dist.all_reduce(flat, op=op)
        for i, t in zip(idx, _unflatten_dense_tensors(flat, group)):
            out[i] = t
    return out  # type: ignore[return-value]


def make_loss_fn(adapter: ModelAdapter, model: torch.nn.Module, *, use_dropout: bool,
                 data_parallel: bool = False) -> Callable:
    """Per-micro-batch loss: (batch, generator) -> (loss, (loss_sum_B, tokens_B)).
    With ``data_parallel`` the loss divides by the token count summed over
    the ranks (this rank's share of the global micro-batch's mean)."""

    def token_total(tokens: torch.Tensor) -> torch.Tensor:
        total = tokens.sum()
        if data_parallel:
            import torch.distributed as dist

            from ..distributed import collective_errors

            total = total.clone()
            with collective_errors():
                dist.all_reduce(total)
        return total

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
            if data_parallel:
                loss = loss * (tokens.sum() / token_total(tokens))
            return loss, (loss.detach() * tokens, tokens)
        loss_sum, tokens = comps
        loss = loss_sum.sum() / token_total(tokens.detach()).clamp_min(1.0)
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
    inject_nan_window: tuple[int, int] | None = None,
    data_parallel: bool = False,
    rank: int = 0,
) -> Callable[..., dict]:
    """The step: ``(state, batch(A, B, T), rollbacks=0) -> metrics``,
    updating ``state`` in place (``rollbacks``: the run's spike rollbacks
    so far, folded into the dropout streams). Metrics: ``loss`` (mean over
    micro-batches of their token-weighted means, over the global
    micro-batch under ``data_parallel``), this rank's
    ``per_example_loss_sum`` and ``per_example_tokens`` (A, B),
    ``grad_norm``, and with the guard ``nonfinite_count`` (a device int32
    scalar)."""
    loss_fn = make_loss_fn(adapter, model, use_dropout=use_dropout,
                           data_parallel=data_parallel)

    def train_step(state: TrainState, batch: dict, rollbacks: int = 0) -> dict[str, Any]:
        params = state.optimizer.params
        for p in params:
            p.grad = None
        losses, loss_sums, token_counts = [], [], []
        for idx in range(grad_accum_steps):
            micro = {k: v[idx] for k, v in batch.items()}
            gen = None
            if use_dropout:
                gen = dropout_generator(seed, state.step, idx, params[0].device, rank,
                                        rollbacks)
            loss, (loss_sum, tokens) = loss_fn(micro, gen)
            loss.backward()
            losses.append(loss.detach())
            loss_sums.append(loss_sum.detach())
            token_counts.append(tokens.detach())
        summed = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        losses_t = torch.stack(losses)
        if data_parallel:
            *summed, losses_t = all_reduce_coalesced([*summed, losses_t])
        grads = [g / grad_accum_steps for g in summed]
        del summed
        if inject_nan_window is not None:
            first, length = inject_nan_window
            # The 1-based optimizer step being taken, a host int: the
            # window is decided without reading the device.
            if first <= state.step + 1 < first + length:
                grads = [g * float("nan") for g in grads]
                losses_t = losses_t * float("nan")
        metrics: dict[str, Any] = {
            "loss": losses_t.mean(),
            "per_example_loss_sum": torch.stack(loss_sums),
            "per_example_tokens": torch.stack(token_counts),
            "grad_norm": global_norm(grads),
        }
        if nonfinite_guard:
            from ..resilience.guard import tree_all_finite

            finite = tree_all_finite(grads, losses_t)
            state.optimizer.step(grads, apply=finite)
            prev = state.nonfinite_count
            if not isinstance(prev, torch.Tensor):
                prev = torch.tensor(prev or 0, dtype=torch.int32, device=finite.device)
            state.nonfinite_count = torch.where(finite, torch.zeros_like(prev), prev + 1)
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


__all__ = [
    "TrainState",
    "all_reduce_coalesced",
    "dropout_generator",
    "make_eval_step",
    "make_loss_fn",
    "make_train_step",
]
