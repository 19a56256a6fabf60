"""Logical-axis rules, the splits they give each leaf, and host memory
(port of ``llmtrain_tpu/parallel/sharding.py``).

The port's mesh is the process group, one device per rank
(distributed/mesh.py). A split is written as JAX writes a
``PartitionSpec``: one entry per dim of the leaf in the JAX package's
layout, None or a tuple of mesh axes. Model code names each dim of a
parameter (``vocab``/``embed``/``heads``/``mlp``/``expert``...), and
:data:`DEFAULT_LOGICAL_AXIS_RULES` maps the names onto mesh axes with
flax's priority rule (:func:`logical_to_mesh_axes`), so every port
parameter, through its flax leaf's layout and names (:func:`param_layout`),
gets the split JAX gives that leaf:

* pure data parallel: every rule lands on a size-1 axis, so parameters
  are replicated and the batch shards over (data, fsdp, expert);
* FSDP: ``embed`` dims split over ``fsdp`` and are gathered at use;
* tensor parallel: ``heads``/``mlp``/``vocab`` split over ``tensor``;
* sequence parallel: the activations' ``length`` splits over
  ``sequence``;
* experts: a MoE layer's ``expert`` dim over ``expert``;
* pipeline: a stacked leaf's ``layers`` dim over ``pipeline``.

:func:`state_shardings` repairs a spec as JAX's does: longer than the
leaf's rank, or a split dim that its axes do not divide, gives a
replicated leaf (the latter with a one-time warning naming it).
:func:`mesh_opt_state_shardings` is ZeRO's rule over data x fsdp x expert
(the free axes of a leaf appended to its first dim that can take them),
:func:`zero_split` the same for one leaf (what parallel/zero.py splits by,
in the leaf's flax layout) and :func:`zero_partition_dim` its one-axis
case.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

logger = logging.getLogger("llmtrain")

_WARNED: set[tuple] = set()

# fmt: off
DEFAULT_LOGICAL_AXIS_RULES: tuple[tuple[str, Any], ...] = (
    # activations
    ("batch", ("data", "fsdp", "expert")),
    ("length", "sequence"),
    ("act_embed", None),
    ("act_mlp", "tensor"),
    ("act_heads", "tensor"),
    ("act_kv", None),
    ("act_vocab", "tensor"),
    # MoE dispatch layout: the expert dim over ``expert``, the token
    # groups over the rest of the batch axes (the all-to-all between them).
    ("act_expert", "expert"),
    ("act_expert_group", ("data", "fsdp")),
    # params
    ("vocab", "tensor"),
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("qkv", None),
    ("position", None),
    ("norm", None),
    ("expert", "expert"),
    # Stacked-layer params (models/gpt_pipeline.py): the leading layer dim
    # over the pipeline stages; the per-layer dims reuse the names above.
    ("layers", "pipeline"),
)
# fmt: on

# The axes whose product is the batch-sharding degree, and ZeRO's
# partitioning axes (the replicas that hold redundant state copies).
BATCH_AXES = ("data", "fsdp", "expert")
ZERO_PARTITION_AXES = BATCH_AXES

Spec = tuple  # one entry per dim: None or a tuple of mesh axis names


def logical_to_mesh_axes(names: tuple[str | None, ...],
                         rules: tuple = DEFAULT_LOGICAL_AXIS_RULES) -> Spec:
    """flax's ``logical_to_mesh_axes``: rules in priority order, each rule
    whose logical name a dim carries takes it when that dim is still free
    and none of its mesh axes is used by another dim; a dim no rule took
    is None. Entries are tuples of axis names (a single axis as a 1-tuple)."""
    unassigned = object()
    result: list[Any] = [unassigned if isinstance(n, str) else None for n in names]
    used: set[str] = set()
    for logical, mesh_axes in rules:
        if logical not in names:
            continue
        pos = names.index(logical)
        axes = () if mesh_axes is None else (
            (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes))
        if result[pos] is unassigned and not used & set(axes):
            result[pos] = axes or None
            used.update(axes)
    return tuple(None if r is unassigned else r for r in result)


def data_parallel_degree(sizes: dict[str, int]) -> int:
    """Batch shards: the product of the axes ``batch`` maps onto (the
    expert axis carries batch shards for the dense parameters)."""
    return math.prod(sizes.get(a, 1) for a in BATCH_AXES)


def batch_sharding(*, with_accum_dim: bool = False) -> Spec:
    """The spec of (B, T) token batches, or (A, B, T): rows over (data,
    fsdp, expert), the length over ``sequence``."""
    spec = (BATCH_AXES, ("sequence",))
    return (None, *spec) if with_accum_dim else spec


def mesh_axis_sizes(sizes: dict[str, int]) -> dict[str, int]:
    """The axis sizes a checkpoint manifest records: every axis of the
    mesh, in mesh order (an axis not given is 1)."""
    from ..autotune.plan import MESH_AXES

    return {axis: int(sizes.get(axis, 1)) for axis in MESH_AXES}


def _shards(sizes: dict[str, int], axes: Any) -> int:
    return 1 if not axes else math.prod(sizes.get(a, 1) for a in axes)


def _spec_fits(sizes: dict[str, int], spec: Spec, shape: tuple[int, ...]) -> bool:
    """Every split dim of ``shape`` is divisible by its axes' product."""
    return all(dim % _shards(sizes, axes) == 0 for dim, axes in zip(shape, spec))


def state_shardings(sizes: dict[str, int],
                    leaves: dict[str, tuple[tuple[int, ...], tuple[str | None, ...] | None]],
                    rules: tuple = DEFAULT_LOGICAL_AXIS_RULES) -> dict[str, Spec]:
    """``{leaf: spec}`` for leaves given as ``{leaf: (shape, logical names
    or None)}``: no names (a scalar, an unnamed leaf) is replicated, ``()``;
    JAX's two repairs give ``()`` too: a spec longer than the leaf's rank,
    and a split dim its axes do not divide (with a one-time warning naming
    a leaf other than a (1,) placeholder)."""
    out: dict[str, Spec] = {}
    for path, (shape, names) in leaves.items():
        shape = tuple(int(d) for d in shape)
        if names is None:
            out[path] = ()
            continue
        spec = logical_to_mesh_axes(tuple(names), rules)
        if len(spec) > len(shape):
            out[path] = ()
            continue
        if not _spec_fits(sizes, spec, shape):
            if shape != (1,):
                key = (path, shape, spec)
                if key not in _WARNED:
                    _WARNED.add(key)
                    logger.warning(
                        "sharding spec %s does not divide leaf %s with shape "
                        "%s on mesh %s; storing this leaf REPLICATED (pick "
                        "dims divisible by the mapped axis sizes to shard it)",
                        _spec_text(spec), path, shape, sizes,
                    )
            out[path] = ()
            continue
        out[path] = spec
    return out


def _spec_text(spec: Spec) -> str:
    def one(axes):
        if axes is None:
            return "None"
        return repr(axes[0]) if len(axes) == 1 else repr(tuple(axes))
    return f"PartitionSpec({', '.join(one(a) for a in spec)})"


def mesh_opt_state_shardings(sizes: dict[str, int], specs: dict[str, tuple[tuple[int, ...], Spec]],
                             *, subject: str = "optimizer-state") -> dict[str, Spec]:
    """ZeRO's layout (JAX ``opt_state_shardings``): each leaf's spec, given
    as ``{leaf: (shape, base spec)}``, with the data x fsdp x expert axes
    it does not use yet appended to the first dim whose size divides by
    its current shards times their product. A leaf with no such dim (a
    scalar, an indivisible shape) keeps its base spec, with a one-time
    warning for a leaf of more than one element. Applied to the
    parameters it is ZeRO stage 2's gradient layout."""
    free_template = [a for a in ZERO_PARTITION_AXES if sizes.get(a, 1) > 1]
    out: dict[str, Spec] = {}
    for path, (shape, base) in specs.items():
        shape = tuple(int(d) for d in shape)
        if not free_template or not shape:
            out[path] = base
            continue
        spec = list(base) + [None] * (len(shape) - len(base))
        used = {a for axes in spec if axes for a in axes}
        free = [a for a in free_template if a not in used]
        if not free:
            out[path] = base
            continue
        free_product = math.prod(sizes[a] for a in free)
        for i, dim in enumerate(shape):
            names = tuple(spec[i] or ())
            if dim % (_shards(sizes, names) * free_product) == 0:
                spec[i] = names + tuple(free)
                out[path] = tuple(spec)
                break
        else:
            if math.prod(shape) > 1:
                key = ("zero", subject, path, shape)
                if key not in _WARNED:
                    _WARNED.add(key)
                    logger.warning(
                        "ZeRO: %s leaf %s with shape %s has no dim divisible by the "
                        "data-parallel product %d; this leaf stays REPLICATED across "
                        "the %s axes", subject, path, shape, free_product, "/".join(free),
                    )
            out[path] = base
    return out


# --------------------------------------------------------------------------
# the port's parameters in the JAX package's layout
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamLayout:
    """A port parameter as its flax leaf: the logical name of each dim in
    the JAX package's layout (None: no names, replicated), and the views
    between the two layouts. ``to_flax`` views a tensor of any split of
    the parameter (the dims it infers are split with it); ``from_flax``
    makes a contiguous port tensor back."""

    names: tuple[str | None, ...] | None
    to_flax: Callable[[torch.Tensor], torch.Tensor]
    from_flax: Callable[[torch.Tensor], torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _contig(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def _dense_t(t: torch.Tensor) -> torch.Tensor:
    return t.T


def _dense_back(t: torch.Tensor) -> torch.Tensor:
    return t.T.contiguous()


_GPT_NORMS = frozenset({"ln_1", "ln_2", "ln_f"})
# models/gpt_pipeline.py's leaves, stored in their flax layout: the logical
# names of each dim (a stacked leaf's ``layers`` first).
_PIPELINE_NAMES: dict[str, tuple[str, ...]] = {
    "ln1_scale": ("layers", "embed"), "ln1_bias": ("layers", "embed"),
    "qkv_kernel": ("layers", "embed", "qkv", "heads", "kv"),
    "qkv_bias": ("layers", "qkv", "heads", "kv"),
    "q_kernel": ("layers", "embed", "heads", "kv"), "q_bias": ("layers", "heads", "kv"),
    "kv_kernel": ("layers", "embed", "qkv", "heads", "kv"),
    "kv_bias": ("layers", "qkv", "heads", "kv"),
    "out_kernel": ("layers", "heads", "kv", "embed"), "out_bias": ("layers", "embed"),
    "ln2_scale": ("layers", "embed"), "ln2_bias": ("layers", "embed"),
    "fc_kernel": ("layers", "embed", "mlp"), "fc_bias": ("layers", "mlp"),
    "proj_kernel": ("layers", "mlp", "embed"), "proj_bias": ("layers", "embed"),
    "ln_f_scale": ("embed",), "ln_f_bias": ("embed",),
}
_RMS_NORMS = frozenset({"attn_norm", "mlp_norm", "norm_f"})
_EXPERT_NAMES = {"wi": ("expert", "embed", "mlp"), "wg": ("expert", "embed", "mlp"),
                 "wu": ("expert", "embed", "mlp"), "bi": ("expert", "mlp"),
                 "wo": ("expert", "mlp", "embed"), "bo": ("expert", "embed")}


def param_layout(name: str, head_dim: int) -> ParamLayout:
    """The flax leaf of a GPT- or llama-family parameter (models/gpt.py,
    llama.py, moe.py, gpt_pipeline.py): its logical names and the views between the
    layouts (interop/flax_params.py's transforms, for any split).
    Parameters of other models have no names (replicated)."""
    parts = name.split(".")
    leaf, module = parts[-1], parts[-2] if len(parts) > 1 else ""
    plain = ParamLayout
    if name in _PIPELINE_NAMES:
        return plain(_PIPELINE_NAMES[name], _same, _contig)
    if module in ("qkv_proj", "kv_proj", "q_proj"):
        lead = () if module == "q_proj" else ("qkv",)
        n = {"qkv_proj": 3, "kv_proj": 2}.get(module)
        out_shape = ((n,) if n else ()) + (-1, head_dim)
        if leaf == "weight":
            return plain(("embed", *lead, "heads", "kv"),
                         lambda w: w.T.reshape(w.shape[1], *out_shape),
                         lambda k: k.reshape(k.shape[0], -1).T.contiguous())
        return plain((*lead, "heads", "kv"), lambda b: b.reshape(*out_shape),
                     lambda b: b.reshape(-1).contiguous())
    if module == "out_proj":
        if leaf == "weight":
            return plain(("heads", "kv", "embed"),
                         lambda w: w.T.reshape(-1, head_dim, w.shape[0]),
                         lambda k: k.reshape(-1, k.shape[-1]).T.contiguous())
        return plain(("embed",), _same, _contig)
    if module in ("mlp_fc", "mlp_gate", "mlp_up"):
        return (plain(("embed", "mlp"), _dense_t, _dense_back) if leaf == "weight"
                else plain(("mlp",), _same, _contig))
    if module in ("mlp_proj", "mlp_down"):
        return (plain(("mlp", "embed"), _dense_t, _dense_back) if leaf == "weight"
                else plain(("embed",), _same, _contig))
    if module == "router":
        return plain(("embed", None), _dense_t, _dense_back)
    if module == "moe_mlp" and leaf in _EXPERT_NAMES:
        return plain(_EXPERT_NAMES[leaf], _same, _contig)
    if module == "token_embedding":
        return plain(("vocab", "embed"), _same, _contig)
    if module == "position_embedding":
        return plain(("position", "embed"), _same, _contig)
    if module == "lm_head":
        return plain(("embed", "vocab"), _dense_t, _dense_back)
    if module in _GPT_NORMS:
        return plain(("embed",), _same, _contig)
    if module in _RMS_NORMS:
        return plain(("norm",), _same, _contig)
    return plain(None, _same, _contig)


def zero_split(sizes: dict[str, int], shape: tuple[int, ...], stored: Spec, *, name: str = "",
               subject: str = "optimizer-state") -> tuple[int, tuple[str, ...]] | None:
    """ZeRO's split of one leaf (:func:`mesh_opt_state_shardings` for a
    leaf of whole ``shape`` stored as ``stored``): the dim the free batch
    axes are appended to and those axes, or None when it stays as stored
    (no free axis of size above one, a scalar, or no dim that divides)."""
    shape = tuple(int(d) for d in shape)
    stored = tuple(stored) + (None,) * (len(shape) - len(stored))
    spec = mesh_opt_state_shardings(sizes, {name: (shape, stored)}, subject=subject)[name]
    for dim, (new, old) in enumerate(zip(spec, stored)):
        extra = tuple(new or ())[len(old or ()):]
        if extra:
            return dim, extra
    return None


def zero_partition_dim(shape: tuple[int, ...], world: int, *, name: str = "",
                       subject: str = "optimizer-state") -> int | None:
    """:func:`zero_split`'s one-axis case: the dim a replicated leaf of
    ``shape`` is split along over a ``world``-rank data axis, or None."""
    found = zero_split({"data": int(world)}, shape, (), name=name, subject=subject)
    return None if found is None else found[0]


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


__all__ = [
    "BATCH_AXES",
    "DEFAULT_LOGICAL_AXIS_RULES",
    "ParamLayout",
    "ZERO_PARTITION_AXES",
    "batch_sharding",
    "data_parallel_degree",
    "host_copy",
    "host_memory_kind",
    "logical_to_mesh_axes",
    "mesh_axis_sizes",
    "mesh_opt_state_shardings",
    "param_layout",
    "state_shardings",
    "zero_partition_dim",
    "zero_split",
]
