"""Per-layer activation policies: remat tiers and the block input's host
offload (port of ``llmtrain_tpu/models/activation_policy.py``).

Maps the parsed ``model.extra.activation_tiers`` spec (the grammar is in
config/activation_tiers.py) onto how one block runs (:func:`run_block`):

- ``none``      — the plain block (autograd saves what it saves).
- ``selective`` — ``torch.utils.checkpoint`` with a selective policy that
  saves the matmul outputs (``mm``, ``addmm``, ``bmm``, ``_scaled_mm``:
  JAX's ``dots_saveable``); everything else replays in the backward. The
  hand-written kernels are ``autograd.Function``s over ctypes calls that
  the policy never sees, so they are recomputed, as JAX's Pallas calls
  are under ``dots_saveable``.
- ``full``      — ``torch.utils.checkpoint``, saving only the block input.
- ``offload``   — a full remat whose one saved tensor, the block input,
  is copied to pinned host memory on a side stream while the block's
  forward runs, and back in the backward (:class:`_OffloadedBlock`). A
  non-reentrant checkpoint keeps its inputs alive itself, so it cannot be
  the carrier.

The legacy ``model.remat: true`` with ``remat_policy: dots_no_batch``
(no tier) saves ``mm``/``addmm`` but not ``bmm``
(``dots_with_no_batch_dims_saveable``): :data:`LEGACY_DOTS_NO_BATCH`.

Dropout draws from an explicit ``torch.Generator``, which the checkpoint's
``preserve_rng_state`` does not restore (it covers the global generators
only): each checkpointed block snapshots the generator's state at entry
and replays it before the recompute, so the recompute draws the forward's
masks, as JAX's remat reuses its key.

Offload needs pinned host memory, which needs the card: on the CPU
:func:`resolve_activation_tiers` turns ``offload`` into ``full`` with a
once-per-process warning, the capability discipline of
``resolve_matmul_precision`` (ops/quant.py) and JAX's for a backend
without a ``pinned_host`` space.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Callable

import torch

from ..parallel.sharding import host_copy, host_memory_kind

logger = logging.getLogger("llmtrain")

# The legacy remat path of ``remat_policy: dots_no_batch`` (no tier).
LEGACY_DOTS_NO_BATCH = "dots_no_batch"

_FALLBACK_WARNED: set[str] = set()


def offload_supported(device: torch.device | str | None = None) -> bool:
    """True when ``device`` (default: the card if there is one) can stage
    tensors in pinned host memory (parallel/sharding.py's
    ``host_memory_kind``)."""
    return host_memory_kind("cuda" if device is None else device) is not None


def resolve_activation_tiers(tiers: tuple[str, ...],
                             device: torch.device | str | None = None) -> tuple[str, ...]:
    """Downgrade ``offload`` to ``full`` where ``device`` has no pinned
    host memory, warning once per process."""
    if "offload" not in tiers or offload_supported(device):
        return tiers
    if "offload" not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add("offload")
        n = sum(1 for t in tiers if t == "offload")
        logger.warning(
            "activation_tiers: device %s has no pinned host memory; falling back "
            "offload -> full remat for %d layer(s) (residuals recompute instead of "
            "staging to host)",
            torch.device(device).type if device is not None else "cpu", n,
        )
    return tuple("full" if t == "offload" else t for t in tiers)


def _saving(ops: frozenset[str]) -> Callable[..., Any]:
    """A selective-checkpoint context factory that saves the outputs of
    the aten ops named in ``ops`` and recomputes every other."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        name = getattr(op, "overloadpacket", op).__name__
        return (CheckpointPolicy.MUST_SAVE if name in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


_SAVED_OPS = {
    "selective": frozenset({"mm", "addmm", "bmm", "_scaled_mm"}),
    LEGACY_DOTS_NO_BATCH: frozenset({"mm", "addmm", "_scaled_mm"}),
}


def _take_aux(block: torch.nn.Module) -> torch.Tensor | None:
    """The MoE load-balance loss the block's last forward kept, taken off
    the module (None without experts)."""
    moe = getattr(block, "moe_mlp", None)
    if moe is None:
        return None
    aux, moe.aux_loss = moe.aux_loss, None
    return aux


_SIDE_STREAMS: dict[torch.device, Any] = {}


def _side_stream(device: torch.device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _OffloadedBlock(torch.autograd.Function):
    """A block whose input leaves the device between forward and backward.

    Forward: the input is copied to pinned host memory on a side stream,
    which waits for it, while the block runs on the current stream without
    a graph; then the current stream waits for the copy, so the input's
    device memory goes back to the allocator in the current stream's
    order. (``record_stream`` would defer that free until the allocator
    sees the copy done, and a host that runs ahead of the card would then
    hold every staged input on the device anyway.) Backward: the input
    comes back on the current stream, the block is recomputed with a graph
    through ``run(x, weights)`` on the same weight tensors (a LoRA run's
    merged ones included), and its gradients with respect to the input and
    the weights are returned.
    """

    @staticmethod
    def forward(ctx, run, x, *weights):
        ctx.run, ctx.device = run, x.device
        if x.is_cuda:
            main, stream = torch.cuda.current_stream(x.device), _side_stream(x.device)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                ctx.host = host_copy(x)
        else:
            ctx.host = host_copy(x)
        ctx.save_for_backward(*weights)
        outs = run(x, weights)
        if x.is_cuda:
            main.wait_stream(stream)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        weights = ctx.saved_tensors
        x = ctx.host.to(ctx.device, non_blocking=True)
        ctx.host = None
        need_x, need_w = ctx.needs_input_grad[1], ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = [w.detach().requires_grad_(n) for w, n in zip(weights, need_w)]
            outs = ctx.run(xd, wd)
            pairs = [(o, g) for o, g in zip(outs, grads) if o is not None and g is not None
                     and o.requires_grad]
            inputs = [t for t in (xd, *wd) if t.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                      allow_unused=True) if pairs and inputs else ()
        it = iter(got)
        gx = next(it) if xd.requires_grad else None
        gw = [next(it) if w.requires_grad else None for w in wd]
        return (None, gx, *gw)


def run_block(tier: str, block: torch.nn.Module, x: torch.Tensor,
              attention_mask: torch.Tensor | None, *, deterministic: bool,
              generator: torch.Generator | None) -> torch.Tensor:
    """``block(x, attention_mask, ...)`` under activation tier ``tier``
    (or the legacy :data:`LEGACY_DOTS_NO_BATCH`). Without a graph to keep
    (no grad, e.g. eval) every tier is the plain block."""
    if tier == "none" or not torch.is_grad_enabled():
        return block(x, attention_mask, deterministic=deterministic, generator=generator)
    snapshot = generator.get_state() if generator is not None else None

    def call(inp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        if snapshot is not None:
            generator.set_state(snapshot)  # the forward's dropout masks, again
        out = block(inp, attention_mask, deterministic=deterministic, generator=generator)
        return out, _take_aux(block)

    if tier == "offload" and x.device.type == "meta":
        tier = "full"  # the cost count (telemetry/profiling.py): no host to stage to
    if tier == "offload":
        names = [n for n, _ in block.named_parameters()]
        weights = [p for _, p in block.named_parameters()]

        def run(inp, ws):
            return _with_weights(block, names, ws, lambda: call(inp))

        out, aux = _OffloadedBlock.apply(run, x, *weights)
    else:
        from torch.utils.checkpoint import checkpoint

        if tier == "full":
            out, aux = checkpoint(call, x, use_reentrant=False, preserve_rng_state=False)
        elif tier in _SAVED_OPS:
            out, aux = checkpoint(call, x, use_reentrant=False, preserve_rng_state=False,
                                  context_fn=_saving(_SAVED_OPS[tier]))
        else:
            raise ValueError(f"unknown activation tier {tier!r}")
    if aux is not None:
        block.moe_mlp.aux_loss = aux
    return out


def _with_weights(block: torch.nn.Module, names: list[str], weights, fn):
    """``fn()`` with ``block``'s parameters swapped for ``weights`` (the
    same tensors in the forward; detached copies that require grad in the
    recompute)."""
    from torch.nn.utils.stateless import _reparametrize_module

    with _reparametrize_module(block, dict(zip(names, weights))):
        return fn()


__all__ = [
    "LEGACY_DOTS_NO_BATCH",
    "offload_supported",
    "resolve_activation_tiers",
    "run_block",
]
