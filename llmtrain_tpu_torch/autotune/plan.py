"""One validated object per parallelism layout, and its analytic memory
model (port of ``llmtrain_tpu/autotune/plan.py``).

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
code 2 (resilience/exit_codes.py). :func:`predict_hbm_bytes` is the
per-device memory of a training step under a plan (parameters, gradients,
AdamW's moments, activations by tier, the logits buffer): the feasibility
half of ``plan`` and ``tune`` and the trainer's activation-byte gauges.
Dict math only: no torch import.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

from ..config.activation_tiers import canonical_tier_spec, parse_activation_tiers
from ..resilience.elastic import ELASTIC_AXES, MODEL_AXES, describe_topology

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

    @property
    def data_parallel(self) -> int:
        """The batch-sharding degree (data x fsdp x expert)."""
        return math.prod(self.axes[a] for a in ELASTIC_AXES)

    @property
    def model_parallel(self) -> int:
        return math.prod(self.axes[a] for a in MODEL_AXES)

    @property
    def global_micro_batch(self) -> int:
        return self.micro_batch_size * self.data_parallel

    def mesh_axis_sizes(self) -> dict[str, int]:
        """The axis sizes a checkpoint manifest records, in mesh order."""
        return {axis: int(self.axes[axis]) for axis in MESH_AXES}

    def describe_topology(self, *, num_processes: int = 1) -> dict[str, Any]:
        """The manifest topology block (resilience/elastic.py) this plan
        produces; resume validation consumes exactly this dict."""
        return describe_topology(
            self.mesh_axis_sizes(),
            data_parallel=self.data_parallel,
            global_micro_batch=self.global_micro_batch,
            micro_batch_size=self.micro_batch_size,
            grad_accum_steps=self.grad_accum_steps,
            num_processes=num_processes,
        )

    def key(self) -> str:
        """Compact stable identity, e.g. ``d2.f2.t1.s1.p1.e2|mb4|remat0|zero1``
        (``|act=<spec>`` appended when a tier ladder is set)."""
        mesh = ".".join(f"{a[0]}{self.axes[a]}" for a in MESH_AXES)
        base = f"{mesh}|mb{self.micro_batch_size}|remat{int(self.remat)}|zero{self.zero_stage}"
        if self.activation_tiers:
            return f"{base}|act={self.activation_tiers}"
        return base

    def config_overrides(self) -> dict[str, Any]:
        """The config fields this plan pins, as a nested dict that
        deep-merges into a ``RunConfig.model_dump()``: the probe configs and
        the emitted tuned YAML are both built through it."""
        overrides: dict[str, Any] = {
            "distributed": {"mesh": self.mesh_axis_sizes()},
            "trainer": {
                "micro_batch_size": self.micro_batch_size,
                "zero": {
                    "enabled": self.zero_stage > 0,
                    "stage": self.zero_stage if self.zero_stage > 0 else 1,
                },
            },
            "model": {"remat": self.remat},
        }
        if self.activation_tiers:
            # Tiers subsume remat; remat pinned off passes the schema's
            # mutual-exclusion check.
            overrides["model"] = {
                "remat": False,
                "extra": {"activation_tiers": self.activation_tiers},
            }
        return overrides


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


# --------------------------------------------------------------------------
# the analytic memory model (per-device prediction)
# --------------------------------------------------------------------------

# Device-resident activation copies of [tokens, d_model] per layer by tier:
# none 14, selective ~6 saved matmul outputs, full 2 (block boundaries),
# offload ~1 (the in-flight staging buffer; the boundary parks on the host).
TIER_ACT_COPIES: dict[str, float] = {
    "none": 14.0,
    "selective": 6.0,
    "full": 2.0,
    "offload": 1.0,
}

# Host-RAM copies of [tokens, d_model] per offload layer: the block-input
# residual, double-buffered so the copy of layer i overlaps layer i+1.
OFFLOAD_HOST_COPIES = 2.0


def plan_layer_tiers(plan: MeshPlan, n_layers: int) -> tuple[str, ...]:
    """The per-layer tiers a plan implies: the parsed spec when set, else
    the remat flag as all ``full`` or all ``none``."""
    if plan.activation_tiers:
        return parse_activation_tiers(plan.activation_tiers, n_layers)
    return ("full",) * n_layers if plan.remat else ("none",) * n_layers


def estimate_param_count(
    *,
    d_model: int,
    n_layers: int,
    d_ff: int,
    vocab_size: int,
    block_size: int,
    tie_embeddings: bool = True,
    n_experts: int = 0,
) -> int:
    """Analytic GPT-shaped parameter count (QKVO + MLP + norms +
    embeddings), for ranking: MoE multiplies the MLP by ``n_experts``
    (plus the router)."""
    attn = 4 * d_model * d_model + 4 * d_model
    mlp = 2 * d_model * d_ff + d_model + d_ff
    if n_experts > 0:
        mlp = mlp * n_experts + d_model * n_experts
    norms = 4 * d_model
    per_layer = attn + mlp + norms
    embed = vocab_size * d_model + block_size * d_model + 2 * d_model
    head = 0 if tie_embeddings else vocab_size * d_model
    return int(n_layers * per_layer + embed + head)


def config_loss_impl(cfg: Any) -> tuple[str, int]:
    """``(loss_impl, ce_chunk)`` the planner assumes for ``cfg``: what the
    port's GPT family resolves at build time (ops/fused_ce.py
    ``resolve_loss_impl``), so a verdict charges the logits buffer the run
    pays. An invalid explicit value resolves to ``dense`` here: config
    validation owns that error."""
    extra = dict(getattr(cfg.model, "extra", {}) or {})
    from ..ops.fused_ce import resolve_loss_impl

    try:
        impl = resolve_loss_impl(
            extra.get("loss_impl"),
            vocab_size=int(cfg.model.vocab_size or 50257),
            ce_auto_vocab=int(extra.get("ce_auto_vocab", 32768) or 32768),
        )
    except ValueError:
        impl = "dense"
    return impl, int(extra.get("ce_chunk", 8192) or 8192)


def predict_hbm_bytes(
    plan: MeshPlan,
    *,
    n_params: int,
    d_model: int,
    n_layers: int,
    vocab_size: int,
    block_size: int,
    dtype_bytes: int = 4,
    param_dtype_bytes: int = 4,
    loss_impl: str = "dense",
    ce_chunk: int = 8192,
) -> dict[str, float]:
    """Predicted per-device memory of a training step under ``plan``:
    parameters and gradients split over the model axes x fsdp; AdamW's two
    f32 moments, split further over every device under ZeRO; activations
    by tier over the device's tokens (batch / dp, context / sequence), the
    offload tier's boundary counted on the host; the logits buffer: the
    whole ``tokens x V`` f32 under ``dense``, one ``tokens x min(ce_chunk,
    V)`` block under ``chunked_ce``, nothing under ``fused_ce`` (the kernel
    streams its tiles)."""
    model_shard = plan.axes["tensor"] * plan.axes["pipeline"] * plan.axes["fsdp"]
    if plan.axes["expert"] > 1:
        model_shard *= plan.axes["expert"]
    params_b = n_params * param_dtype_bytes / max(model_shard, 1)
    grads_b = n_params * dtype_bytes / max(model_shard, 1)
    opt_shard = plan.device_count if plan.zero_stage > 0 else max(model_shard, 1)
    opt_b = 2 * n_params * 4.0 / max(opt_shard, 1)
    tokens = plan.micro_batch_size * (block_size / max(plan.axes["sequence"], 1))
    try:
        tiers = plan_layer_tiers(plan, n_layers)
    except ValueError as exc:
        raise MeshPlanError(f"activation_tiers: {exc}") from exc
    per_copy = tokens * d_model * dtype_bytes
    by_tier: dict[str, float] = {}
    host_b = 0.0
    for tier in tiers:
        by_tier[tier] = by_tier.get(tier, 0.0) + per_copy * TIER_ACT_COPIES[tier]
        if tier == "offload":
            host_b += per_copy * OFFLOAD_HOST_COPIES
    acts_b = sum(by_tier.values())
    if loss_impl == "fused_ce":
        logits_b = 0.0
    elif loss_impl == "chunked_ce":
        logits_b = tokens * min(ce_chunk, vocab_size) * 4.0
    else:
        logits_b = tokens * vocab_size * 4.0
    total = params_b + grads_b + opt_b + acts_b + logits_b
    return {
        "loss_impl": loss_impl,
        "params_bytes": round(params_b),
        "grads_bytes": round(grads_b),
        "opt_state_bytes": round(opt_b),
        "activation_bytes": round(acts_b),
        "activation_bytes_by_tier": {t: round(v) for t, v in by_tier.items()},
        "activation_host_bytes": round(host_b),
        "logits_bytes": round(logits_b),
        "total_bytes": round(total),
    }


__all__ = [
    "MESH_AXES",
    "MeshPlan",
    "MeshPlanError",
    "ModelCaps",
    "OFFLOAD_HOST_COPIES",
    "TIER_ACT_COPIES",
    "caps_from_config",
    "config_loss_impl",
    "estimate_param_count",
    "plan_from_config",
    "plan_layer_tiers",
    "predict_hbm_bytes",
    "resolve_axis_sizes",
    "resolve_plan",
]
