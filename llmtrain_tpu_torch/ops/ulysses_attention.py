"""Ulysses (all-to-all) sequence parallelism (port of
``llmtrain_tpu/ops/ulysses_attention.py``; plain PyTorch, as JAX's is
plain XLA).

Where ring attention keeps the queries local and passes K/V around the
sequence group, Ulysses re-shards once per attention: an all-to-all
swaps the split from the sequence to the heads (q, k and v stacked into
one exchange, or q alone and the narrow grouped-query K/V stacked), every
rank runs exact blockwise attention over the whole sequence for its
``H/s`` heads, and a second all-to-all swaps back. Each exchange is an
autograd op whose backward is the inverse exchange
(parallel/collectives.py ``all_to_all``), so no custom backward is
needed. It needs the rank's heads divisible by the sequence degree.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.collectives import all_to_all, gather_dim
from .blockwise_attention import blockwise_attention
from .ring_attention import min_widen_factor, route_or_blockwise


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor | None = None, *, mesh: Any = None,
                      causal: bool = True) -> torch.Tensor:
    """Local-shard Ulysses attention: q (B, T_local, H, D) and narrow k/v
    shards, contiguous along the sequence in group order; ``key_mask`` the
    rank's (B, T_local) mask shard (gathered here to the whole sequence,
    which every rank sees after the exchange). Returns the (B, T_local, H,
    D) output shard."""
    from ..distributed import active_mesh

    mesh = mesh or active_mesh()
    group = mesh.group("sequence")
    s = mesh.size("sequence")
    heads = q.shape[2]
    if heads % s != 0:
        raise ValueError(
            f"ulysses needs local heads ({heads}) divisible by the "
            f"sequence axis size ({s})"
        )
    if k.shape[2] != heads:
        # Narrow K/V crosses narrow when its heads split over the axis;
        # otherwise widened by the smallest exact factor that divides.
        w = min_widen_factor(heads // k.shape[2], k.shape[2], s)
        if w is not None and w > 1:
            k = k.repeat_interleave(w, dim=2)
            v = v.repeat_interleave(w, dim=2)
    if k.shape[2] == heads:
        # One exchange: sequence shard i, all heads -> head slice i, the
        # whole sequence (shards concatenated in group order).
        qkv = all_to_all(torch.stack((q, k, v)), 3, 2, group)
        qh, kh, vh = qkv.unbind(0)
    else:
        qh = all_to_all(q, 2, 1, group)
        kh, vh = all_to_all(torch.stack((k, v)), 3, 2, group).unbind(0)
    mask = None if key_mask is None else gather_dim(key_mask.to(torch.int32), 1, group)
    out = blockwise_attention(qh, kh, vh, causal=causal, key_mask=mask, query_mask=mask)
    # Back: sequence-split, all of the rank's heads.
    return all_to_all(out, 1, 2, group)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *,
                              causal: bool = True,
                              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    return ulysses_attention(q, k, v, key_mask, mesh=mesh, causal=causal)


def _local_heads_divide(mesh: Any, q: torch.Tensor) -> bool:
    """The rank's heads (after the tensor split) divide the sequence axis."""
    return q.shape[2] % mesh.size("sequence") == 0


def ulysses_or_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ulysses when the active mesh shards the sequence and the rank's
    heads divide by it; blockwise otherwise (ring_attention's policy)."""
    return route_or_blockwise(q, k, v, causal=causal, scheme="ulysses",
                              sharded_fn=ulysses_attention_sharded,
                              extra_predicate=_local_heads_divide, key_mask=key_mask)


__all__ = ["ulysses_attention", "ulysses_attention_sharded", "ulysses_or_blockwise"]
