"""Non-finite guard primitives for the train step (port of
``llmtrain_tpu/resilience/guard.py``).

A single NaN/Inf in the loss or gradients — an overflow in bf16 attention
logits, a poisonous batch, a flaky card — would otherwise flow through the
optimizer and corrupt the params AND the Adam moments irreversibly. The
guard computes one ``all_finite`` flag on the device over the loss and
every gradient, and the optimizer applies its update under that flag
(``training/optimizer.py``: every write is a device-side select, so no
value reaches the host): a skipped step keeps params/optimizer state
bit-identical while ``step`` still advances, so the deterministic sampler
moves past the bad batch instead of re-feeding it forever.

The trainer counts CONSECUTIVE skipped updates on the device (a scalar in
the TrainState, read at log boundaries only) and aborts with
:class:`NonFiniteLossError` once the run of skips crosses the configured
cap — persistent non-finiteness means divergence, not a bad batch.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch


class NonFiniteLossError(RuntimeError):
    """Raised by the trainer when ``max_consecutive_nonfinite`` optimizer
    updates in a row had to be skipped by the non-finite guard."""


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)


def tree_all_finite(*trees: Any) -> torch.Tensor:
    """Device bool scalar: every element of every floating tensor in
    ``trees`` (tensors, or lists/tuples/dicts of them) is finite.

    Exact per element, as ``isfinite`` is, in a few multi-tensor launches
    and no host read: ``x * 0`` is 0 for a finite ``x`` and NaN for an
    infinite or NaN one, and the L1 norms of those products add up to 0
    or to NaN (a sum of squares could overflow on finite values)."""
    leaves = [t for tree in trees for t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    zeros = torch._foreach_mul(leaves, 0.0)
    norms = torch._foreach_norm(zeros, 1)
    return torch.isfinite(torch.stack([n.float() for n in norms]).sum())


__all__ = ["NonFiniteLossError", "tree_all_finite"]
