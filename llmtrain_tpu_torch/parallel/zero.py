"""ZeRO over the port's process group: the sharded optimizer state's
collectives and its host offload (``trainer.zero``; JAX reaches the same
through GSPMD shardings, training/trainer.py ``create_state``).

:class:`ZeroPartition` knows which slice of each tensor this rank owns
(parallel/sharding.py's rule) and moves slices between the ranks, each
collective coalesced into one flat buffer per dtype:

* :meth:`~ZeroPartition.gather` — the all-gather that puts every rank's
  slice into the whole tensors (the parameters after a sharded update, a
  state gathered for a checkpoint or for Adafactor's update);
* :meth:`~ZeroPartition.reduce_scatter` — stage 2's gradient sum, each
  rank receiving only its slice;
* :meth:`~ZeroPartition.global_norm` and :meth:`~ZeroPartition.all_true`
  — the clip's norm from an all-reduce of the slices' sums, and the
  non-finite guard's flag agreed over the ranks.

Host offload keeps the state in owned host tensors between steps
(parallel/sharding.py's ``host_copy``: pinned ones on the card, copied in
and out with ``non_blocking`` copies on the current stream; plain copies
on the CPU), never an alias of the working tensors.
"""

from __future__ import annotations

import torch

from .sharding import host_copy, zero_partition_dim


class ZeroPartition:
    """One rank's view of ZeRO at ``stage`` over ``world`` ranks on
    ``device``. With one rank nothing is sharded (JAX's single-device
    identity) and only the host offload acts."""

    def __init__(self, *, stage: int, host_offload: bool, world: int, rank: int,
                 device: torch.device) -> None:
        self.stage = int(stage)
        self.world = int(world)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.host_offload = bool(host_offload)

    @property
    def shards(self) -> bool:
        """True when the state is split (more than one rank)."""
        return self.world > 1

    def dim(self, shape: tuple[int, ...], name: str = "",
            subject: str = "optimizer-state") -> int | None:
        return zero_partition_dim(tuple(shape), self.world, name=name, subject=subject)

    def chunk(self, t: torch.Tensor, dim: int | None, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of ``t`` along ``dim`` (a view; ``t``
        itself for a replicated leaf)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.world
        return t.narrow(dim, rank * n, n)

    def local(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's slice of ``t`` (a view)."""
        return self.chunk(t, dim, self.rank)

    @staticmethod
    def _by_dtype(idx: list[int], tensors: list[torch.Tensor]) -> dict[torch.dtype, list[int]]:
        groups: dict[torch.dtype, list[int]] = {}
        for i in idx:
            groups.setdefault(tensors[i].dtype, []).append(i)
        return groups

    @torch.no_grad()
    def gather(self, pieces: list[torch.Tensor], dims: list[int | None],
               outs: list[torch.Tensor]) -> None:
        """All-gather: every whole tensor ``outs[i]`` with a split dim
        receives every rank's slice, ``pieces[i]`` being this rank's
        (replicated entries are left as they are)."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        idx = [i for i, d in enumerate(dims) if d is not None]
        if not idx or self.world == 1:
            return
        for group in self._by_dtype(idx, pieces).values():
            moved = [pieces[i].movedim(dims[i], 0) for i in group]
            flat = torch.cat([m.reshape(-1) for m in moved])
            out = flat.new_empty(self.world * flat.numel())
            with collective_errors():
                dist.all_gather_into_tensor(out, flat)
            out = out.view(self.world, -1)
            for r in range(self.world):
                off = 0
                for i, m in zip(group, moved):
                    seg = out[r, off:off + m.numel()].view(m.shape)
                    self.chunk(outs[i], dims[i], r).copy_(seg.movedim(0, dims[i]))
                    off += m.numel()

    @torch.no_grad()
    def reduce_scatter(self, fulls: list[torch.Tensor],
                       dims: list[int | None]) -> list[torch.Tensor | None]:
        """Stage 2: each whole tensor with a split dim summed over the ranks,
        this rank receiving only its slice (None for replicated entries)."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        out: list[torch.Tensor | None] = [None] * len(fulls)
        idx = [i for i, d in enumerate(dims) if d is not None]
        for group in self._by_dtype(idx, fulls).values():
            flat = torch.cat([self.chunk(fulls[i], dims[i], r).movedim(dims[i], 0).reshape(-1)
                              for r in range(self.world) for i in group])
            mine = flat.new_empty(flat.numel() // self.world)
            with collective_errors():
                dist.reduce_scatter_tensor(mine, flat)
            off = 0
            for i in group:
                moved = self.local(fulls[i], dims[i]).movedim(dims[i], 0)
                out[i] = mine[off:off + moved.numel()].view(moved.shape).movedim(0, dims[i])
                off += moved.numel()
        return out

    def global_norm(self, grads: list[torch.Tensor], dims: list[int | None]) -> torch.Tensor:
        """The global norm of gradients held as this rank's slices (split
        entries) and whole tensors (replicated ones): each rank sums the
        squares of its slices, rank 0 adds the replicated ones, and one
        all-reduce adds the ranks' sums (a reassociation of the replicated
        path's sum)."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g, d in zip(grads, dims):
            if d is not None or self.rank == 0:
                total = total + torch.sum(g.float() * g.float())
        with collective_errors():
            dist.all_reduce(total)
        return torch.sqrt(total)

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A device bool true on every rank iff it is true on all of them."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        t = flag.to(torch.int32)
        with collective_errors():
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return t.bool()

    # ------------------------------------------------------------ host offload

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        """An owned host copy of ``t`` (``host_copy``)."""
        return host_copy(t)

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A working copy of a host tensor on the run's device (an owned
        copy on the CPU too: the update never writes into the stored
        state)."""
        return host.to(self.device, non_blocking=host.is_pinned(), copy=True)

    def write_back(self, host: torch.Tensor, t: torch.Tensor) -> None:
        """The updated working copy ``t`` into its host tensor."""
        host.copy_(t, non_blocking=t.is_cuda)


__all__ = ["ZeroPartition"]
