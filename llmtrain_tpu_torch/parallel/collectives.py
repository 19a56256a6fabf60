"""Collectives with their transposes, for the mesh's model axes.

Each op is a ``torch.autograd.Function`` whose backward is the forward's
transpose over the same process group (``group`` None: one rank, every op
the identity):

* :func:`copy_to` — identity forward, all-reduce backward (Megatron's
  ``f``, the input of a column-parallel product);
* :func:`reduce_from` — all-reduce forward, identity backward (Megatron's
  ``g``, the output of a row-parallel product);
* :func:`gather` — all-gather along a dim forward, this rank's slice
  backward (a split operand every rank then uses alike: the logits or
  the vocab matrix under ``tensor``);
* :func:`gather_rs` — all-gather forward, reduce-scatter backward (an
  operand every rank then uses on its own data: an fsdp-split weight, the
  K/V of a sequence shard);
* :func:`all_to_all` — split one dim into the group's ranks, concatenate
  what they send along another; backward the inverse exchange.

The gathers and the reduce-scatter move a dim to the front, so the slices
are contiguous, and back.
"""

from __future__ import annotations

from typing import Any

import torch


def _size(group: Any) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _rank(group: Any) -> int:
    import torch.distributed as dist

    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (a no-op for None)."""
    if group is not None:
        import torch.distributed as dist

        from ..distributed import collective_errors

        with collective_errors():
            dist.all_reduce(t, group=group)
    return t


def gather_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The group's slices of ``t`` concatenated along ``dim`` in group
    order (no autograd)."""
    n = _size(group)
    if n == 1:
        return t
    import torch.distributed as dist

    from ..distributed import collective_errors

    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
    with collective_errors():
        dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """``t`` summed over the group, this rank keeping its slice along
    ``dim`` (no autograd)."""
    n = _size(group)
    if n == 1:
        return t
    import torch.distributed as dist

    from ..distributed import collective_errors

    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    with collective_errors():
        dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def slice_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` over the group."""
    n = _size(group)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, _rank(group) * size, size)


def exchange(t: torch.Tensor, split_dim: int, concat_dim: int, group: Any) -> torch.Tensor:
    """All-to-all: ``t`` split along ``split_dim`` into the group's ranks;
    what rank j sends lands j-th along ``concat_dim`` (JAX's tiled
    ``all_to_all``; no autograd)."""
    n = _size(group)
    if n == 1:
        return t
    import torch.distributed as dist

    from ..distributed import collective_errors

    send = torch.stack(t.chunk(n, dim=split_dim), 0).contiguous()
    recv = torch.empty_like(send)
    with collective_errors():
        dist.all_to_all_single(recv, send, group=group)
    # recv[i]: rank i's chunk for this rank.
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return slice_dim(grad, ctx.dim, ctx.group).contiguous(), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return exchange(grad, concat_dim, split_dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim, group)


def gather_rs(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    return x if group is None else _GatherRS.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group: Any) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim, group)


__all__ = [
    "all_reduce_",
    "all_to_all",
    "copy_to",
    "exchange",
    "gather",
    "gather_dim",
    "gather_rs",
    "reduce_from",
    "reduce_scatter_dim",
    "slice_dim",
]
