"""The ZeRO partition rule and host memory (port of the single-axis part of
``llmtrain_tpu/parallel/sharding.py``).

In the port the data axis is the process group of
``distributed.setup_distributed`` (NCCL on the card, gloo on the CPU), one
device per process, so the data-parallel product (JAX's
``ZERO_PARTITION_AXES``: data x fsdp x expert) is the world size; the
``fsdp``, ``tensor``, ``sequence`` and ``expert`` axes are meshes, which
the trainer refuses (ROADMAP.md queue A: parallelism).

:func:`zero_partition_dim` is JAX's ``opt_state_shardings`` for one leaf:
the first dim divisible by the world size takes the split; scalars and
leaves with no such dim stay replicated, with a one-time warning naming a
leaf of more than one element (Adafactor's ``(1,)`` placeholders stay
silent). One process shards nothing: every leaf keeps its whole shape.
"""

from __future__ import annotations

import logging
import math
from typing import Any

import torch

logger = logging.getLogger("llmtrain")

_WARNED: set[tuple] = set()


def zero_partition_dim(shape: tuple[int, ...], world: int, *, name: str = "",
                       subject: str = "optimizer-state") -> int | None:
    """The dim a leaf of ``shape`` is split along over ``world`` ranks, or
    None when it stays replicated (one rank, a scalar, or no dim divisible
    by ``world``: then a one-time warning for a leaf of more than one
    element)."""
    shape = tuple(int(d) for d in shape)
    if world <= 1 or not shape:
        return None
    for i, dim in enumerate(shape):
        if dim % world == 0:
            return i
    if math.prod(shape) > 1:
        key = ("zero", subject, name, shape)
        if key not in _WARNED:
            _WARNED.add(key)
            logger.warning(
                "ZeRO: %s leaf %s with shape %s has no dim divisible by the "
                "data-parallel product %d; this leaf stays REPLICATED across "
                "the data axis", subject, name, shape, world,
            )
    return None


def opt_state_shardings(shapes: dict[str, tuple[int, ...]], world: int, *,
                        subject: str = "optimizer-state") -> dict[str, int | None]:
    """``{leaf name: split dim or None}`` for a tree of leaf shapes over
    ``world`` ranks (:func:`zero_partition_dim` per leaf). Applied to the
    parameters it is ZeRO stage 2's gradient layout."""
    return {name: zero_partition_dim(shape, world, name=name, subject=subject)
            for name, shape in shapes.items()}


def host_memory_kind(device: torch.device | str | Any) -> str | None:
    """``"pinned_host"`` where ``device`` can stage tensors in page-locked
    host memory (a CUDA device), else None (on the CPU the device IS the
    host, so a pinned space would pretend otherwise)."""
    dev = torch.device(device)
    return "pinned_host" if dev.type == "cuda" and torch.cuda.is_available() else None


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """An owned host copy of ``t``, never an alias: pinned and filled by a
    ``non_blocking`` copy on the current stream for a tensor on the card,
    a plain copy on the CPU."""
    host = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=t.is_cuda)
    host.copy_(t.detach(), non_blocking=t.is_cuda)
    return host


__all__ = ["host_copy", "host_memory_kind", "opt_state_shardings", "zero_partition_dim"]
