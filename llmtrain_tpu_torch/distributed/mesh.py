"""The named device mesh over the process group (port of JAX's
``MESH_AXES``, ``resolve_mesh_axes`` and ``build_mesh``,
``llmtrain_tpu/distributed/__init__.py``).

JAX lays a mesh over the devices of one or more processes; the port's
mesh is the process group, one device per rank. Ranks are laid out
row-major in :data:`MESH_AXES` order, ``data`` outermost, so rank ``r``
holds the coordinates of JAX's device ``r``. :func:`build_mesh` creates a
sub-group for every product of the axes larger than one (every rank calls
``new_group`` for every group, in one order), so a collective over any
set of axes (the tensor group, the sequence ring, the data x fsdp x
expert batch group, the pipeline stages) has its group ready. A one-rank mesh has no groups:
every axis is 1 and nothing is split.

The trainer sets the run's mesh with :func:`set_active_mesh`; the models
and the sequence-parallel attention read it with :func:`active_mesh`
(the ambient mesh JAX reads from ``with mesh:``).
"""

from __future__ import annotations

import itertools
import math
from typing import Any

from ..autotune.plan import MESH_AXES, resolve_axis_sizes

_ACTIVE: "DeviceMesh | None" = None


def resolve_mesh_axes(mesh_cfg: Any, device_count: int) -> dict[str, int]:
    """The six axis sizes of ``distributed.mesh`` over ``device_count``
    devices, one ``-1`` wildcard filled (``MeshPlanError`` otherwise)."""
    return resolve_axis_sizes(mesh_cfg.axis_sizes(), device_count)


class DeviceMesh:
    """One rank's view of the mesh: the axis sizes, its coordinates, and
    the process groups over products of axes."""

    def __init__(self, sizes: dict[str, int], rank: int,
                 groups: dict[tuple[str, ...], Any] | None = None) -> None:
        self.sizes = {a: int(sizes[a]) for a in MESH_AXES}
        self.rank = int(rank)
        self.world = math.prod(self.sizes.values())
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {rank} outside a mesh of {self.world} devices")
        self.coords = dict(zip(MESH_AXES, _unravel(self.rank, self.sizes)))
        self._groups = groups or {}

    def _axes(self, axes: tuple[str, ...]) -> tuple[str, ...]:
        """``axes`` in mesh order, the axes of size one dropped."""
        for a in axes:
            if a not in self.sizes:
                raise KeyError(f"unknown mesh axis {a!r}; expected one of {MESH_AXES}")
        return tuple(a for a in MESH_AXES if a in axes and self.sizes[a] > 1)

    def size(self, *axes: str) -> int:
        """The product of the sizes of ``axes``."""
        return math.prod(self.sizes[a] for a in self._axes(axes)) if axes else 1

    def index(self, *axes: str) -> int:
        """This rank's index in the group over ``axes`` (row-major in mesh
        order: the order of the slices a collective over them joins)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def group(self, *axes: str) -> Any:
        """The process group over ``axes`` this rank belongs to, or None
        when their product is one."""
        key = self._axes(axes)
        if not key:
            return None
        return self._groups[key]

    def group_ranks(self, *axes: str) -> list[int]:
        """The global ranks of this rank's group over ``axes``, in group
        order."""
        return _group_ranks(self.sizes, self.coords, self._axes(axes))

    @property
    def model_parallel(self) -> bool:
        """True when an axis other than data splits parameters or
        activations (fsdp, tensor, sequence, pipeline, expert)."""
        return self.size("fsdp", "tensor", "sequence", "pipeline", "expert") > 1

    def axis_sizes(self) -> dict[str, int]:
        return dict(self.sizes)


def _unravel(rank: int, sizes: dict[str, int]) -> list[int]:
    coords = []
    for a in reversed(MESH_AXES):
        coords.append(rank % sizes[a])
        rank //= sizes[a]
    return coords[::-1]


def _ravel(coords: dict[str, int], sizes: dict[str, int]) -> int:
    idx = 0
    for a in MESH_AXES:
        idx = idx * sizes[a] + coords[a]
    return idx


def _group_ranks(sizes: dict[str, int], coords: dict[str, int],
                 axes: tuple[str, ...]) -> list[int]:
    ranks = []
    for combo in itertools.product(*(range(sizes[a]) for a in axes)):
        c = dict(coords)
        c.update(zip(axes, combo))
        ranks.append(_ravel(c, sizes))
    return ranks


def build_mesh(mesh_cfg: Any, world: int, rank: int) -> DeviceMesh:
    """The mesh of ``distributed.mesh`` over the ``world`` ranks of the
    process group (``MeshPlanError`` when the axes do not tile it)."""
    sizes = resolve_mesh_axes(mesh_cfg, world)
    wide = [a for a in MESH_AXES if sizes[a] > 1]
    groups: dict[tuple[str, ...], Any] = {}
    if wide:
        import torch.distributed as dist

        for n in range(1, len(wide) + 1):
            for axes in itertools.combinations(wide, n):
                others = [a for a in MESH_AXES if a not in axes]
                # Every rank creates every group of this product, in one order.
                for fixed in itertools.product(*(range(sizes[a]) for a in others)):
                    base = dict(zip(others, fixed), **{a: 0 for a in axes})
                    ranks = _group_ranks(sizes, base, axes)
                    g = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                    if rank in ranks:
                        groups[axes] = g
    return DeviceMesh(sizes, rank, groups)


def set_active_mesh(mesh: DeviceMesh | None) -> None:
    """Make ``mesh`` the run's mesh (None clears it)."""
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh() -> DeviceMesh | None:
    """The run's mesh, or None outside a mesh run."""
    return _ACTIVE


__all__ = [
    "MESH_AXES",
    "DeviceMesh",
    "active_mesh",
    "build_mesh",
    "resolve_mesh_axes",
    "set_active_mesh",
]
