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
* :meth:`~ZeroPartition.global_norm` — the clip's norm from an
  all-reduce of the slices' sums.

Every leaf is split as JAX splits it (parallel/sharding.py ``zero_split``,
JAX's ``opt_state_shardings``): in its flax layout (parallel/sharding.py
``param_layout``), along the first dim that takes the batch axes (data x
fsdp x expert) its parameter's stored split leaves free. A :class:`Split`
names that dim, those axes and the view of a port tensor in the flax
layout; each collective runs over the group of its leaves' axes. So a
rank holds the elements of JAX's device of the same mesh coordinates, on
a mesh (parallel/mesh_params.py ``MeshLayout``) as on a data axis alone.

Host offload keeps the state in owned host tensors between steps
(parallel/sharding.py's ``host_copy``: pinned ones on the card, copied in
and out with ``non_blocking`` copies on the current stream; plain copies
on the CPU), never an alias of the working tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .sharding import host_copy, zero_split


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclass(frozen=True)
class Split:
    """A state leaf's ZeRO split: along ``dim`` of its ``view`` (the flax
    layout, a view of the port tensor) over the mesh ``axes``."""

    dim: int
    axes: tuple[str, ...]
    view: Callable[[torch.Tensor], torch.Tensor] = _same


class ZeroPartition:
    """One rank's view of ZeRO at ``stage`` on ``device``, the parameters
    laid out by ``layout`` (a :class:`~.mesh_params.MeshLayout`; None: one
    process, nothing sharded, JAX's single-device identity, and only the
    host offload acts)."""

    def __init__(self, *, stage: int, host_offload: bool, layout: Any,
                 device: torch.device) -> None:
        self.stage = int(stage)
        self.layout = layout
        self.mesh = layout.mesh if layout is not None else None
        self.world = self.mesh.world if self.mesh is not None else 1
        self.device = torch.device(device)
        self.host_offload = bool(host_offload)

    @property
    def shards(self) -> bool:
        """True when the state is split (more than one rank)."""
        return self.world > 1

    def _ranks(self, split: Split) -> tuple[int, int]:
        """(ranks, this rank's index) of a split's group."""
        return self.mesh.size(*split.axes), self.mesh.index(*split.axes)

    def dim(self, shape: tuple[int, ...], name: str = "",
            subject: str = "optimizer-state", param: str | None = None) -> Split | None:
        """The split of a leaf of ``shape`` (``param``: the parameter whose
        state it is, default ``name``), or None (as its parameter is
        stored). A leaf of the parameter's stored shape splits in the
        parameter's flax layout; one of its own shape (Adafactor's
        factored moments) as it is."""
        if not self.shards:
            return None
        leaf = self.layout.leaves[param or name]
        if tuple(shape) == leaf.local_shape:
            view, whole, stored = leaf.layout.to_flax, leaf.flax_shape, leaf.stored
        else:
            view, whole, stored = _same, tuple(shape), ()
        found = zero_split(self.mesh.sizes, whole, stored, name=name, subject=subject)
        return None if found is None else Split(found[0], found[1], view)

    def chunk(self, t: torch.Tensor, split: Split | None, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of ``t`` (its index in the split's group;
        a view in the split's layout, ``t`` itself for a replicated leaf)."""
        if split is None:
            return t
        t = split.view(t)
        n = t.shape[split.dim] // self._ranks(split)[0]
        return t.narrow(split.dim, rank * n, n)

    def local(self, t: torch.Tensor, split: Split | None) -> torch.Tensor:
        """This rank's slice of ``t`` (a view)."""
        if split is None:
            return t
        return self.chunk(t, split, self._ranks(split)[1])

    @staticmethod
    def _by_dtype(idx: list[int], tensors: list[torch.Tensor],
                  dims: list[Split | None]) -> dict[Any, list[int]]:
        """Leaf indices grouped by (split axes, dtype): one flat buffer and
        one collective each."""
        groups: dict[Any, list[int]] = {}
        for i in idx:
            groups.setdefault((dims[i].axes, tensors[i].dtype), []).append(i)
        return groups

    @torch.no_grad()
    def gather(self, pieces: list[torch.Tensor], dims: list[Split | None],
               outs: list[torch.Tensor]) -> None:
        """All-gather: every whole tensor ``outs[i]`` with a split dim
        receives every rank's slice, ``pieces[i]`` being this rank's
        (replicated entries are left as they are)."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        idx = [i for i, d in enumerate(dims) if d is not None]
        if not idx or self.world == 1:
            return
        for group in self._by_dtype(idx, pieces, dims).values():
            n, _ = self._ranks(dims[group[0]])
            pg = self.mesh.group(*dims[group[0]].axes)
            moved = [pieces[i].movedim(dims[i].dim, 0) for i in group]
            flat = torch.cat([m.reshape(-1) for m in moved])
            out = flat.new_empty(n * flat.numel())
            with collective_errors():
                dist.all_gather_into_tensor(out, flat, group=pg)
            out = out.view(n, -1)
            for r in range(n):
                off = 0
                for i, m in zip(group, moved):
                    seg = out[r, off:off + m.numel()].view(m.shape)
                    self.chunk(outs[i], dims[i], r).copy_(seg.movedim(0, dims[i].dim))
                    off += m.numel()

    @torch.no_grad()
    def reduce_scatter(self, fulls: list[torch.Tensor],
                       dims: list[Split | None]) -> list[torch.Tensor | None]:
        """Stage 2: each whole tensor with a split dim summed over its
        split's ranks, this rank receiving only its slice (None for
        replicated entries)."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        out: list[torch.Tensor | None] = [None] * len(fulls)
        idx = [i for i, d in enumerate(dims) if d is not None]
        for group in self._by_dtype(idx, fulls, dims).values():
            n, _ = self._ranks(dims[group[0]])
            pg = self.mesh.group(*dims[group[0]].axes)
            flat = torch.cat([self.chunk(fulls[i], dims[i], r).movedim(dims[i].dim, 0)
                              .reshape(-1) for r in range(n) for i in group])
            mine = flat.new_empty(flat.numel() // n)
            with collective_errors():
                dist.reduce_scatter_tensor(mine, flat, group=pg)
            off = 0
            for i in group:
                moved = self.local(fulls[i], dims[i]).movedim(dims[i].dim, 0)
                out[i] = mine[off:off + moved.numel()].view(moved.shape).movedim(0, dims[i].dim)
                off += moved.numel()
        return out

    def global_norm(self, names: list[str], grads: list[torch.Tensor],
                    dims: list[Split | None]) -> torch.Tensor:
        """The global norm of stage 2's gradients (this rank's slices of
        the split leaves, whole replicated ones): each element counted
        once over the ranks (``MeshLayout.global_norm``)."""
        return self.layout.global_norm(names, grads,
                                       [d.axes if d is not None else () for d in dims])

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


__all__ = ["Split", "ZeroPartition"]
