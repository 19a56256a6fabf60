"""One validated object per parallelism layout (port of the fail-fast
part of ``llmtrain_tpu/autotune/plan.py``).

:func:`plan_from_config` resolves ``distributed.mesh`` against the device
count (in the port: the ranks of the process group, one device each) and
checks every rule that would otherwise fail deep inside the trainer:

* one ``-1`` wildcard at most, and the axis product equals the device
  count (:func:`resolve_axis_sizes`);
* ``pipeline > 1`` needs a model that stacks its layers;
* ``sequence > 1`` with ring or ulysses needs ``block_size % sequence``,
  ulysses also ``n_heads % sequence``;
* ``tensor > 1`` needs ``n_heads`` and ``n_kv_heads`` divisible by it;
* ``expert > 1`` on a MoE model needs ``n_experts % expert``;
* the ZeRO stage and the activation-tier rules.

Every violation raises :class:`MeshPlanError`, which the CLI maps to exit
code 2 (resilience/exit_codes.py). Dict math only: no torch import.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

from ..config.activation_tiers import canonical_tier_spec, parse_activation_tiers
from ..resilience.elastic import ELASTIC_AXES, MODEL_AXES

# Canonical axis order: data outermost. A rank's mesh coordinates are its
# index unravelled row-major over these sizes (distributed/mesh.py).
MESH_AXES = ("data", "fsdp", "tensor", "sequence", "pipeline", "expert")

assert set(ELASTIC_AXES) | set(MODEL_AXES) == set(MESH_AXES)


class MeshPlanError(ValueError):
    """A parallelism layout that cannot run: the axis sizes do not tile
    the device count, a model dimension does not divide, or the model
    lacks a capability the layout needs. A config problem: exit code 2."""


def resolve_axis_sizes(sizes: Mapping[str, int], device_count: int) -> dict[str, int]:
    """The six axis sizes against ``device_count``, one ``-1`` wildcard
    filled. Raises :class:`MeshPlanError` for two wildcards, fixed axes
    that do not divide the device count, or a product that misses it."""
    out = {axis: int(sizes.get(axis, 1)) for axis in MESH_AXES}
    for axis, v in out.items():
        if v == 0 or v < -1:
            raise MeshPlanError(f"mesh axis {axis!r} must be a positive int or -1 (got {v})")
    wildcards = [axis for axis, v in out.items() if v == -1]
    if len(wildcards) > 1:
        raise MeshPlanError(f"at most one mesh axis may be -1 (wildcard); got {wildcards}")
    fixed = math.prod(v for v in out.values() if v != -1)
    if wildcards:
        if device_count % fixed != 0:
            raise MeshPlanError(
                f"device count {device_count} not divisible by fixed mesh "
                f"axes product {fixed} (axes {dict(out)}) — the "
                f"{wildcards[0]!r} wildcard cannot be filled"
            )
        out[wildcards[0]] = device_count // fixed
        fixed *= out[wildcards[0]]
    if fixed != device_count:
        raise MeshPlanError(
            f"mesh axes {dict(out)} multiply to {fixed} but {device_count} "
            "devices are available — axis sizes must exactly tile the "
            "device count"
        )
    return out


@dataclass(frozen=True)
class ModelCaps:
    """What a plan validates against: capability flags and the model
    dimensions the axes split."""

    n_heads: int
    block_size: int
    supports_pipeline: bool = False
    attention: str = "dense"
    n_kv_heads: int = 0
    n_experts: int = 0
    pipeline_microbatches: int = 4
    n_layers: int = 0  # 0: unknown, tier specs pass unvalidated


def caps_from_config(cfg: Any, adapter: Any | None = None) -> ModelCaps:
    """:class:`ModelCaps` of a ``RunConfig`` (``adapter``, a class or an
    instance, gives ``supports_pipeline``)."""
    extra = dict(cfg.model.extra or {})
    return ModelCaps(
        n_heads=int(cfg.model.n_heads),
        block_size=int(cfg.model.block_size),
        supports_pipeline=bool(getattr(adapter, "supports_pipeline", False)),
        attention=str(cfg.model.attention),
        n_kv_heads=int(extra.get("n_kv_heads", 0) or 0),
        n_experts=int(extra.get("n_experts", 0) or 0),
        pipeline_microbatches=int(extra.get("pipeline_microbatches", 4) or 4),
        n_layers=int(cfg.model.n_layers),
    )


@dataclass(frozen=True)
class MeshPlan:
    """One resolved, validated layout (build it with :func:`resolve_plan`).
    ``axes`` holds all six sizes, no wildcard."""

    axes: dict[str, int]
    device_count: int
    micro_batch_size: int
    grad_accum_steps: int
    remat: bool = False
    zero_stage: int = 0
    attention: str = "dense"
    model_name: str = ""
    activation_tiers: str = ""


def resolve_plan(
    *,
    mesh_sizes: Mapping[str, int],
    device_count: int,
    caps: ModelCaps,
    micro_batch_size: int,
    grad_accum_steps: int = 1,
    remat: bool = False,
    zero_stage: int = 0,
    attention: str | None = None,
    model_name: str = "",
    activation_tiers: str = "",
) -> MeshPlan:
    """Resolve and validate one layout (the rules of the module docstring,
    each with JAX's message)."""
    axes = resolve_axis_sizes(mesh_sizes, device_count)
    att = caps.attention if attention is None else attention
    if micro_batch_size < 1:
        raise MeshPlanError(f"micro_batch_size must be >= 1 (got {micro_batch_size})")
    if zero_stage not in (0, 1, 2):
        raise MeshPlanError(f"zero_stage must be 0 (off), 1 or 2 (got {zero_stage})")

    pp = axes["pipeline"]
    if pp > 1:
        if not caps.supports_pipeline:
            raise MeshPlanError(
                f"mesh axis 'pipeline' is {pp} but model "
                f"{model_name or '?'!r} does not stack its layers for "
                "pipeline stages; use a pipeline-capable model (e.g. "
                "'gpt_pipeline') or set pipeline to 1"
            )
        m = max(caps.pipeline_microbatches, 1)
        if micro_batch_size % m != 0:
            raise MeshPlanError(
                f"trainer.micro_batch_size ({micro_batch_size}) must be "
                f"divisible by model.extra.pipeline_microbatches ({m}) on "
                "a pipeline mesh — otherwise the global micro-batch "
                "cannot split into pipeline microbatches"
            )

    sp = axes["sequence"]
    if sp > 1 and att in ("ring", "ulysses"):
        if caps.block_size % sp != 0:
            raise MeshPlanError(
                f"model.block_size ({caps.block_size}) must be divisible "
                f"by the mesh sequence axis ({sp}) — each {att} shard "
                "holds an equal context slice"
            )
        if att == "ulysses" and caps.n_heads % sp != 0:
            raise MeshPlanError(
                f"model.n_heads ({caps.n_heads}) must be divisible by the "
                f"mesh sequence axis ({sp}) — ulysses all-to-alls between "
                "sequence shards and head shards"
            )

    tp = axes["tensor"]
    if tp > 1:
        if caps.n_heads % tp != 0:
            raise MeshPlanError(
                f"model.n_heads ({caps.n_heads}) must be divisible by the "
                "mesh tensor axis "
                f"({tp}) — attention heads shard over tensor parallelism"
            )
        if caps.n_kv_heads and caps.n_kv_heads % tp != 0:
            raise MeshPlanError(
                f"model.extra.n_kv_heads ({caps.n_kv_heads}) must be "
                f"divisible by the mesh tensor axis ({tp}) — K/V heads "
                "shard over tensor parallelism like query heads do"
            )

    ep = axes["expert"]
    if ep > 1 and caps.n_experts > 0 and caps.n_experts % ep != 0:
        raise MeshPlanError(
            f"model.extra.n_experts ({caps.n_experts}) must be "
            f"divisible by the mesh expert axis ({ep}) — each shard "
            "holds an equal expert slice"
        )

    tiers_spec = str(activation_tiers or "")
    if tiers_spec:
        if remat:
            raise MeshPlanError(
                "model.remat: true conflicts with activation_tiers; tiers "
                "subsume the remat flag"
            )
        if caps.n_layers > 0:
            try:
                tiers_spec = canonical_tier_spec(
                    parse_activation_tiers(tiers_spec, caps.n_layers))
            except ValueError as exc:
                raise MeshPlanError(f"activation_tiers: {exc}") from exc

    return MeshPlan(
        axes=axes,
        device_count=device_count,
        micro_batch_size=int(micro_batch_size),
        grad_accum_steps=int(grad_accum_steps),
        remat=bool(remat),
        zero_stage=int(zero_stage),
        attention=att,
        model_name=model_name,
        activation_tiers=tiers_spec,
    )


def plan_from_config(cfg: Any, device_count: int, *, adapter: Any | None = None) -> MeshPlan:
    """The plan the config resolves to on ``device_count`` devices."""
    zero = cfg.trainer.zero
    return resolve_plan(
        mesh_sizes=cfg.distributed.mesh.axis_sizes(),
        device_count=device_count,
        caps=caps_from_config(cfg, adapter),
        micro_batch_size=cfg.trainer.micro_batch_size,
        grad_accum_steps=cfg.trainer.grad_accum_steps,
        remat=cfg.model.remat,
        zero_stage=int(zero.stage) if zero.enabled else 0,
        attention=cfg.model.attention,
        model_name=cfg.model.name,
        activation_tiers=str((cfg.model.extra or {}).get("activation_tiers", "") or ""),
    )


__all__ = [
    "MESH_AXES",
    "MeshPlan",
    "MeshPlanError",
    "ModelCaps",
    "caps_from_config",
    "plan_from_config",
    "resolve_axis_sizes",
    "resolve_plan",
]
