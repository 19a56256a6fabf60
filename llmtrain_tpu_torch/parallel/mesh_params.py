"""A model's parameters laid out over the mesh (the port's counterpart of
the trainer's ``state_shardings`` placement in JAX).

Each parameter has two splits, both written in the JAX package's layout
(parallel/sharding.py :func:`~.sharding.param_layout`):

* the **stored** split: JAX's spec for its flax leaf, repairs included
  (:func:`~.sharding.state_shardings`); this rank keeps that slice, so
  its bytes are the split leaves' parts plus the replicated leaves;
* the **compute** split: what the rank's module computes with, the dims
  the model itself splits over ``tensor`` (heads, the mlp dim, the
  vocabulary where it divides) and ``expert`` (the experts), read off the
  rank's module shapes.

Where they differ (an ``embed`` dim over ``fsdp``, or a leaf JAX stores
replicated whose dim the model splits) the forward runs on the compute
tensor made from the stored one (:meth:`MeshLayout.materialized`): the
``fsdp`` dims all-gathered just in time (their gradient reduce-scattered
back), a replicated leaf sliced. After the backward each gradient is
summed over the axes it is still partial on (:meth:`MeshLayout.reduce_axes`):
the batch axes and ``sequence`` that its stored split and the collectives
of the forward have not summed already, and the axes it was sliced over;
never over ``tensor`` otherwise, where Megatron's conjugate pairs keep
the ranks' gradients whole. Checkpoints hold whole arrays: gathered at
save (:meth:`MeshLayout.whole`), sliced at load (:meth:`MeshLayout.local`).
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Any, Iterator

import torch

from .collectives import gather, gather_dim, gather_rs
from .sharding import ParamLayout, Spec, param_layout, state_shardings

_BATCH_AND_SEQUENCE = ("data", "fsdp", "sequence", "expert")

# A model built for a mesh -> its layout (kept beside the module, not on it:
# the layout holds the mesh's process groups, which a deepcopy of the
# module must not try to copy).
_LAYOUTS: "weakref.WeakKeyDictionary[torch.nn.Module, MeshLayout]" = weakref.WeakKeyDictionary()


def attach(model: torch.nn.Module, layout: "MeshLayout") -> None:
    _LAYOUTS[model] = layout


def layout_of(model: torch.nn.Module) -> "MeshLayout | None":
    """The layout a model was built with for a mesh, or None."""
    return _LAYOUTS.get(model)


class _Leaf:
    def __init__(self, name: str, layout: ParamLayout, flax_shape: tuple[int, ...],
                 stored: Spec, compute: Spec) -> None:
        self.name, self.layout, self.flax_shape = name, layout, flax_shape
        self.stored = tuple(stored) + (None,) * (len(flax_shape) - len(stored))
        self.compute = compute
        used = {a for axes in self.stored if axes for a in axes}
        # Per dim: the stored axes the forward gathers, the compute axes
        # it slices.
        self.gather = [tuple(a for a in (s or ()) if a not in (c or ()))
                       for s, c in zip(self.stored, compute)]
        self.slice = [tuple(a for a in (c or ()) if a not in (s or ()))
                      for s, c in zip(self.stored, compute)]
        sliced = {a for axes in self.slice for a in axes}
        self.reduce = tuple(a for a in ("data", "fsdp", "tensor", "sequence", "expert")
                            if (a in _BATCH_AND_SEQUENCE and a not in used) or a in sliced)
        self.split_axes = tuple(sorted(used))

    @property
    def needs_materialize(self) -> bool:
        return any(self.gather) or any(self.slice)


class MeshLayout:
    """The stored and compute splits of every parameter of a model on
    ``mesh`` (the module docstring). ``global_shapes`` are the parameters'
    whole port shapes, ``local`` the rank's module (its compute shapes)."""

    def __init__(self, mesh: Any, global_shapes: dict[str, tuple[int, ...]],
                 local: torch.nn.Module, head_dim: int) -> None:
        self.mesh = mesh
        sizes = mesh.axis_sizes()
        params = dict(local.named_parameters())
        layouts = {n: param_layout(n, head_dim) for n in global_shapes}
        flax_shapes = {n: tuple(layouts[n].to_flax(torch.empty(s, device="meta")).shape)
                       for n, s in global_shapes.items()}
        stored = state_shardings(sizes, {n: (flax_shapes[n], layouts[n].names)
                                         for n in global_shapes})
        self.leaves: dict[str, _Leaf] = {}
        for name, layout in layouts.items():
            local_flax = layout.to_flax(torch.empty(params[name].shape, device="meta")).shape
            compute = []
            for d, (whole, part) in enumerate(zip(flax_shapes[name], local_flax)):
                if whole == part:
                    compute.append(None)
                else:
                    name_d = layout.names[d] if layout.names else None
                    axis = {"expert": "expert", "layers": "pipeline"}.get(name_d, "tensor")
                    if whole != part * mesh.size(axis):
                        raise ValueError(f"{name}: dim {d} of {whole} is not split into "
                                         f"{part} by the {axis} axis")
                    compute.append((axis,))
            self.leaves[name] = _Leaf(name, layout, flax_shapes[name], stored[name],
                                      tuple(compute))
        for name, leaf in self.leaves.items():
            # The port shape this rank stores (what the optimizer updates).
            leaf.local_shape = tuple(self.local(name, torch.empty(global_shapes[name],
                                                                  device="meta")).shape)

    # ------------------------------------------------------------ slices

    def _view_slice(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        for d, axes in enumerate(spec):
            if axes and self.mesh.size(*axes) > 1:
                n = self.mesh.size(*axes)
                size = t.shape[d] // n
                t = t.narrow(d, self.mesh.index(*axes) * size, size)
        return t

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's stored slice of a whole port tensor."""
        leaf = self.leaves[name]
        return leaf.layout.from_flax(self._view_slice(leaf.layout.to_flax(whole), leaf.stored))

    def whole(self, name: str, stored: torch.Tensor) -> torch.Tensor:
        """The whole port tensor from every rank's stored slice (a
        collective over the leaf's split axes; every rank calls it)."""
        leaf = self.leaves[name]
        t = leaf.layout.to_flax(stored.detach())
        for d, axes in enumerate(leaf.stored):
            if axes and self.mesh.size(*axes) > 1:
                t = gather_dim(t, d, self.mesh.group(*axes))
        return leaf.layout.from_flax(t)

    def compute_tensor(self, name: str, stored: torch.Tensor) -> torch.Tensor:
        """The tensor the rank's module computes with, from its stored
        slice (autograd: the gathers reduce-scatter the gradient back)."""
        leaf = self.leaves[name]
        t = leaf.layout.to_flax(stored)
        for d in range(t.dim()):
            if leaf.gather[d]:
                # A dim stored split over ``tensor`` that the module uses
                # whole feeds the same computation on every rank of the
                # group: each takes its slice of the gradient. Split over a
                # batch axis, the ranks' gradients differ and are summed.
                gather_fn = gather if leaf.gather[d] == ("tensor",) else gather_rs
                t = gather_fn(t, d, self.mesh.group(*leaf.gather[d]))
            if leaf.slice[d]:
                n = self.mesh.size(*leaf.slice[d])
                size = t.shape[d] // n
                t = t.narrow(d, self.mesh.index(*leaf.slice[d]) * size, size)
        return leaf.layout.from_flax(t)

    # ------------------------------------------------------------ the model

    def put(self, local: torch.nn.Module, name: str, whole: torch.Tensor) -> None:
        """Make parameter ``name`` of ``local`` this rank's stored slice of
        the whole port tensor ``whole`` (a new parameter of the stored
        shape, in the module's dtype, on ``whole``'s device)."""
        mod_name, _, attr = name.rpartition(".")
        module = local.get_submodule(mod_name)
        old = getattr(module, attr)
        with torch.no_grad():
            value = self.local(name, whole).to(old.dtype).clone()
        setattr(module, attr, torch.nn.Parameter(value, requires_grad=old.requires_grad))

    def whole_state_dict(self, local: torch.nn.Module) -> dict[str, torch.Tensor]:
        """The model's whole state dict (a collective)."""
        return {n: self.whole(n, p) for n, p in local.state_dict().items()}

    def load_whole(self, local: torch.nn.Module, whole: dict[str, torch.Tensor]) -> None:
        """Load a whole state dict (a checkpoint's) into the rank's slices."""
        missing = sorted(set(self.leaves) - set(whole))
        unexpected = sorted(set(whole) - set(self.leaves))
        if missing or unexpected:
            raise RuntimeError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
        with torch.no_grad():
            mine = self.reshard_state(whole)
            for name, p in local.named_parameters():
                p.copy_(mine[name].to(p.device, p.dtype))

    def reshard_state(self, whole: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """JAX's ``reshard_state`` for whole arrays: each parameter's stored
        slice on this rank of this mesh (a state saved on another mesh
        re-sharded by slicing)."""
        return {name: self.local(name, t) for name, t in whole.items()}

    @property
    def needs_materialize(self) -> bool:
        return any(leaf.needs_materialize for leaf in self.leaves.values())

    @contextmanager
    def materialized(self, local: torch.nn.Module) -> Iterator[None]:
        """The module's parameters replaced by their compute tensors for
        the calls inside (nothing to do when every leaf computes as
        stored)."""
        if not self.needs_materialize:
            yield
            return
        from torch.nn.utils.stateless import _reparametrize_module

        params = dict(local.named_parameters())
        tensors = {n: self.compute_tensor(n, p) for n, p in params.items()
                   if self.leaves[n].needs_materialize}
        with _reparametrize_module(local, tensors):
            yield

    # ------------------------------------------------------------ gradients

    def reduce_axes(self, name: str) -> tuple[str, ...]:
        """The axes (of size > 1) a gradient of ``name`` is summed over."""
        return tuple(a for a in self.leaves[name].reduce if self.mesh.sizes[a] > 1)

    def split_axes(self, name: str) -> tuple[str, ...]:
        """The axes the stored leaf is split over."""
        return tuple(a for a in self.leaves[name].split_axes if self.mesh.sizes[a] > 1)

    def counts_once(self, name: str, extra: tuple[str, ...] = ()) -> bool:
        """True on the one rank of each replica set of the stored leaf (its
        coordinate 0 on every axis it is not split over, ``extra`` counted
        as split): summing its elements there counts each once."""
        split = set(self.split_axes(name)) | set(extra)
        return all(self.mesh.coords[a] == 0 for a, n in self.mesh.sizes.items()
                   if n > 1 and a not in split)

    def global_norm(self, names: list[str], grads: list[torch.Tensor],
                    sliced: list[tuple[str, ...]] | None = None) -> torch.Tensor:
        """The global norm of the gradients of parameters ``names`` as this
        rank holds them (its stored slices; ``sliced[i]``: the ZeRO axes
        gradient i is a further slice over): each rank sums the squares of
        the elements it holds the counted copy of (:meth:`counts_once`), in
        parameter order, and one all-reduce adds the ranks' sums."""
        import torch.distributed as dist

        from ..distributed import collective_errors

        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for i, (name, g) in enumerate(zip(names, grads)):
            if self.counts_once(name, sliced[i] if sliced is not None else ()):
                total = total + torch.sum(g.float() * g.float())
        with collective_errors():
            dist.all_reduce(total)
        return torch.sqrt(total)


def model_layout(model: torch.nn.Module, mesh: Any, head_dim: int) -> MeshLayout:
    """The layout of ``model`` on ``mesh``: the one it was built with
    (:func:`build_for_mesh`), else that of a model whose every parameter
    this rank holds whole (the mesh splits none of its dims)."""
    return layout_of(model) or MeshLayout(
        mesh, {n: tuple(p.shape) for n, p in model.named_parameters()}, model, head_dim=head_dim)


def build_for_mesh(model_class: type, kwargs: dict[str, Any], mesh: Any, *, moe: bool,
                   device: torch.device | None, seed: int) -> torch.nn.Module:
    """A GPT- or llama-family module for this rank of ``mesh`` (heads, mlp
    dim and vocabulary over ``tensor``, experts over ``expert``, the
    sequence over ``sequence``, a stacked model's layer rows over
    ``pipeline``), holding its stored slices of the weights
    the one-device model draws from ``seed``; the layout is attached
    (:func:`layout_of`). The whole model and the rank's are built on the
    meta device, and each parameter is drawn whole on ``device`` in the
    one-device order (``init_plan``, one generator) and cut to the rank's
    slice before the next: the peak is one whole parameter beside the
    rank's slices, and the weights are the one-device model's bit for bit."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    split = dict(tensor_parallel=mesh.sizes["tensor"], sequence_parallel=mesh.sizes["sequence"],
                 expert_parallel=mesh.sizes["expert"] if moe else 1)
    if getattr(model_class, "stacks_layers", False):
        split["pipeline_parallel"] = mesh.sizes["pipeline"]
    with torch.device("meta"):
        whole = model_class(**kwargs)
        local = model_class(**kwargs, **split)
    params = dict(whole.named_parameters())
    layout = MeshLayout(mesh, {n: tuple(p.shape) for n, p in params.items()}, local,
                        head_dim=kwargs["d_model"] // kwargs["n_heads"])
    generator = torch.Generator(device=device).manual_seed(seed)
    plan = whole.init_plan()
    if sorted(n for n, _ in plan) != sorted(params):
        raise RuntimeError(f"{model_class.__name__}.init_plan does not fill every parameter once")
    for name, fill in plan:
        value = torch.empty_like(params[name], device=device)
        with torch.no_grad():
            fill(value, generator)
        layout.put(local, name, value)
        del value
    attach(local, layout)
    return local


__all__ = ["MeshLayout", "attach", "build_for_mesh", "layout_of", "model_layout"]
