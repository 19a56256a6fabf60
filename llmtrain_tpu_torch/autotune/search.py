"""Candidate enumeration and analytic pruning for ``tune`` (port of
``llmtrain_tpu/autotune/search.py``).

The search space is mesh shape x micro-batch x activation regime (remat,
tier ladder) x ZeRO stage. Every candidate is scored analytically first
(PaLM's flop model, utils/hw.py; the plan's memory prediction,
autotune/plan.py; the ``DEVICE_PEAKS`` roofline, telemetry/profiling.py),
and infeasible or dominated candidates are discarded before any device
time is spent, each with its reason (``topology-illegal``,
``infeasible-hbm``, ``dominated``, ``probe-budget``).

:func:`lowered_candidate_cost` replaces the analytic byte estimate with a
count of the step itself: where JAX lowers the step through XLA's
``cost_analysis``, the port runs one train micro-step on ``meta`` tensors
under telemetry/profiling.py's counting mode (ops/cost.py for the
hand-written kernels): nothing executes and no device memory is touched.
The analytic path remains the fallback.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from ..resilience.elastic import TopologyMismatchError, classify_topology_change
from ..telemetry.profiling import classify_roofline, gradient_collective_bytes
from ..utils.hw import transformer_flops_per_token
from ..config.activation_tiers import canonical_tier_spec, parse_activation_tiers
from .plan import (
    MESH_AXES,
    MeshPlan,
    MeshPlanError,
    ModelCaps,
    estimate_param_count,
    plan_layer_tiers,
    predict_hbm_bytes,
    resolve_plan,
)

logger = logging.getLogger("llmtrain")

# Recompute-FLOPs factor by activation tier, applied as the mean over
# layers. none re-runs nothing; full/offload re-run the forward inside
# the backward (the classic ~4/3 on 6N); selective replays only the cheap
# elementwise ops between saved matmul outputs.
TIER_FLOPS_FACTOR: dict[str, float] = {
    "none": 1.0,
    "selective": 1.1,
    "full": 4.0 / 3.0,
    "offload": 4.0 / 3.0,
}

# Host<->device staging bandwidth for the offload tier's analytical time
# term (bytes/s) — a PCIe4/DMA-class placeholder, deliberately coarse:
# it only has to rank offload ladders against recompute, not predict
# wall-clock.
HOST_DMA_BYTES_PER_SEC = 100e9

# Per-device memory by device kind (bytes), substring-matched like
# DEVICE_PEAKS (longest key wins); ``tune.hbm_limit_bytes`` overrides.
# JAX's TPU rows are kept. The h100 row is the H100 SXM's 80 GB of HBM3
# (the datasheet's figure, the card the port runs on). The cpu row is a
# placeholder generous enough for every smoke shape yet small enough that
# deliberately oversized test candidates still prune.
DEVICE_HBM_BYTES: dict[str, float] = {
    "v4": 32e9,
    "v5e": 16e9,
    "v5 lite": 16e9,
    "v5p": 95e9,
    "v6e": 32e9,
    "v6 lite": 32e9,
    "h100": 80e9,
    "cpu": 8e9,
}


def resolve_hbm_limit(
    device_kind: str | None, override: float | None = None
) -> float:
    """Per-device HBM budget for feasibility pruning (bytes)."""
    if override:
        return float(override)
    kind = (device_kind or "cpu").lower()
    best, limit = "", DEVICE_HBM_BYTES["cpu"]
    for key, cap in DEVICE_HBM_BYTES.items():
        if key in kind and len(key) > len(best):
            best, limit = key, cap
    return limit


def _factorizations(n: int, slots: int) -> list[tuple[int, ...]]:
    """All ordered tuples of ``slots`` positive ints whose product is n."""
    if slots == 1:
        return [(n,)]
    out: list[tuple[int, ...]] = []
    for d in range(1, n + 1):
        if n % d == 0:
            out.extend((d, *rest) for rest in _factorizations(n // d, slots - 1))
    return out


@dataclass
class Candidate:
    """One enumerated layout, before/after scoring.

    ``plan`` is None until :func:`prune_candidates` validates the raw
    knobs — enumeration is deliberately broader than what can run, so
    that illegal layouts show up in the tune report with their pruning
    reason instead of being silently never generated.
    """

    mesh_sizes: dict[str, int]
    micro_batch_size: int
    remat: bool
    zero_stage: int
    # Tier-ladder spec ("" = legacy remat flag only) — carried into the
    # plan key and tune_report.json so a "winner changed" note names the
    # ladder, not just a remat bit.
    activation_tiers: str = ""
    plan: MeshPlan | None = None
    predicted: dict[str, Any] = field(default_factory=dict)

    def key(self) -> str:
        if self.plan is not None:
            return self.plan.key()
        mesh = ".".join(f"{a[0]}{self.mesh_sizes.get(a, 1)}" for a in MESH_AXES)
        base = (
            f"{mesh}|mb{self.micro_batch_size}"
            f"|remat{int(self.remat)}|zero{self.zero_stage}"
        )
        if self.activation_tiers:
            return f"{base}|act={self.activation_tiers}"
        return base


def enumerate_candidates(
    cfg: Any,
    device_count: int,
    *,
    seed: int,
    microbatch_candidates: list[int] | None = None,
    search_mesh: bool = True,
    search_remat: bool = True,
    search_zero: bool = True,
) -> list[Candidate]:
    """The full candidate grid, in a deterministic seeded order.

    Mesh shapes are every factorization of ``device_count`` over the six
    named axes (capability filtering happens in the pruning pass, with
    reasons); microbatches default to {mb/2, mb, 2mb} around the config's
    value; remat and zero stage toggle when their search knob is on.
    The list is built in canonical sorted order, then shuffled with
    ``random.Random(seed)`` — same seed, same order, every run (JAX's
    order too).
    """
    base_mb = int(cfg.trainer.micro_batch_size)
    zero_cfg = cfg.trainer.zero
    base_zero = int(zero_cfg.stage) if zero_cfg.enabled else 0

    if search_mesh:
        shapes = sorted(_factorizations(device_count, len(MESH_AXES)))
        # On a dense model the expert axis is just more data parallelism
        # (parallel/sharding.py) — every expert>1 shape is semantically
        # identical to a data-axis twin already in the grid, so skip the
        # duplicates rather than spend probes on them. MoE models keep
        # them: expert placement is a real layout choice there.
        n_experts = int((cfg.model.extra or {}).get("n_experts", 0) or 0)
        if n_experts <= 0:
            expert_slot = MESH_AXES.index("expert")
            shapes = [s for s in shapes if s[expert_slot] == 1]
    else:
        from .plan import resolve_axis_sizes

        fixed = resolve_axis_sizes(cfg.distributed.mesh.axis_sizes(), device_count)
        shapes = [tuple(fixed[a] for a in MESH_AXES)]

    if microbatch_candidates:
        mbs = sorted({int(m) for m in microbatch_candidates if int(m) >= 1})
    else:
        mbs = sorted({m for m in (base_mb // 2, base_mb, base_mb * 2) if m >= 1})
    zeros = [0, 1, 2] if search_zero else [base_zero]

    # Activation axis: (remat, tier-ladder) pairs. The legacy remat
    # toggle IS the all-none / all-full ladder pair (plan_layer_tiers
    # maps remat0 -> none:*, remat1 -> full:*), so those ladders stay as
    # the unsuffixed remat0/remat1 keys; searching additionally proposes
    # the offload-bottom-K ladder (bottom-of-stack residuals are the
    # cheapest to stage — they are reused last in the backward pass).
    # A config that already pins a tier spec forces every candidate to
    # carry an explicit spec: the emitted overrides deep-merge over the
    # base config, and an override without a spec would silently inherit
    # the base ladder under a key that claims plain remat.
    n_layers = int(cfg.model.n_layers)
    base_spec = str((cfg.model.extra or {}).get("activation_tiers", "") or "")
    if base_spec:
        base_spec = canonical_tier_spec(
            parse_activation_tiers(base_spec, n_layers)
        )
    k = max(1, n_layers // 4)
    if n_layers > k:
        offload_ladder = f"offload:0-{k - 1},full:{k}-{n_layers - 1}"
    else:
        offload_ladder = "offload:*"
    offload_ladder = canonical_tier_spec(
        parse_activation_tiers(offload_ladder, n_layers)
    )
    if base_spec:
        if search_remat:
            specs = list(dict.fromkeys(
                [base_spec, "none:*", "full:*", offload_ladder]
            ))
        else:
            specs = [base_spec]
        activations = [(False, s) for s in specs]
    elif search_remat:
        activations = [(False, ""), (True, ""), (False, offload_ladder)]
    else:
        activations = [(bool(cfg.model.remat), "")]

    grid = [
        Candidate(
            mesh_sizes=dict(zip(MESH_AXES, shape)),
            micro_batch_size=mb,
            remat=remat,
            zero_stage=z,
            activation_tiers=tiers,
        )
        for shape in shapes
        for mb in mbs
        for remat, tiers in activations
        for z in zeros
    ]
    random.Random(seed).shuffle(grid)
    return grid


def analytic_candidate_cost(
    plan: MeshPlan, cfg: Any, *, n_params: int | None = None
) -> dict[str, float]:
    """Per-device flops / bytes / collective bytes of one train micro-step
    under ``plan`` — the pure fallback when no backend is available to
    lower against (and the cross-check the tests pin).

    FLOPs come from the PaLM 6N model; remat re-runs the forward pass, a
    ~4/3 factor on 6N.  Bytes are a coarse traffic model: three passes
    over the resident param/grad shard plus the layer activations read+
    written twice each — enough for roofline *class* ranking, which is
    all the pruner consumes.
    """
    m = cfg.model
    if n_params is None:
        n_params = estimate_param_count(
            d_model=m.d_model,
            n_layers=m.n_layers,
            d_ff=m.d_ff,
            vocab_size=int(m.vocab_size or 50257),
            block_size=m.block_size,
            tie_embeddings=m.tie_embeddings,
            n_experts=int((m.extra or {}).get("n_experts", 0) or 0),
        )
    flops_per_token = transformer_flops_per_token(
        n_params=n_params,
        n_layers=m.n_layers,
        seq_len=m.block_size,
        d_model=m.d_model,
    )
    tokens_global = plan.global_micro_batch * m.block_size
    tiers = plan_layer_tiers(plan, m.n_layers)
    remat_factor = sum(TIER_FLOPS_FACTOR[t] for t in tiers) / len(tiers)
    flops = flops_per_token * tokens_global / plan.device_count * remat_factor

    dtype_b = 2 if m.dtype == "bfloat16" else 4
    model_shard = max(
        plan.axes["tensor"] * plan.axes["pipeline"] * plan.axes["fsdp"], 1
    )
    param_bytes = n_params * dtype_b / model_shard
    tokens_dev = tokens_global / plan.device_count
    act_bytes = tokens_dev * m.d_model * m.n_layers * 4.0 * dtype_b
    bytes_accessed = param_bytes * 3.0 + act_bytes
    collective = gradient_collective_bytes(
        plan.axes, n_params * 4.0 / model_shard
    )
    # Offload tier staging traffic: each offloaded block-input residual
    # crosses the host link twice per step (D2H after forward, H2D before
    # its backward). Separate from bytes_accessed — it rides the DMA
    # engines, not HBM (ranked via HOST_DMA_BYTES_PER_SEC in the pruner).
    n_offload = sum(1 for t in tiers if t == "offload")
    offload_bytes = tokens_dev * m.d_model * dtype_b * 2.0 * n_offload
    return {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "collective_bytes": float(collective),
        "offload_bytes": float(offload_bytes),
        "n_params": float(n_params),
        "source": "analytic",
    }


def lowered_candidate_cost(cfg: Any, plan: MeshPlan) -> dict[str, float] | None:
    """Counted cost of one train micro-step: the adapter's loss and its
    backward over the plan's global micro-batch, run on ``meta`` tensors
    under the counting mode of telemetry/profiling.py (nothing executes,
    no device memory is touched), per device by ``plan.device_count``.
    Returns None on any failure (the analytic model stands in)."""
    try:
        import torch

        from ..registry import get_model_adapter, initialize_registries
        from ..telemetry.profiling import count_cost_profile

        initialize_registries()
        adapter = get_model_adapter(cfg.model.name)()
        with torch.device("meta"):  # the GPT family's modules, storage-free
            model = adapter._model_class(**adapter.model_kwargs(cfg)).train()
        tokens = torch.empty((plan.global_micro_batch, cfg.model.block_size),
                             dtype=torch.int32, device="meta")
        batch = {"input_ids": tokens, "labels": tokens}

        def step() -> None:
            loss, _ = adapter.compute_loss(model, batch, deterministic=True)
            loss.backward()

        prof = count_cost_profile(step, name="tune_candidate")
        if prof is None:
            return None
        grad_bytes = sum(p.numel() * 4.0 for p in model.parameters())
        model_shard = max(
            plan.axes["tensor"] * plan.axes["pipeline"] * plan.axes["fsdp"], 1
        )
        tiers = plan_layer_tiers(plan, cfg.model.n_layers)
        remat_factor = sum(TIER_FLOPS_FACTOR[t] for t in tiers) / len(tiers)
        dtype_b = 2 if cfg.model.dtype == "bfloat16" else 4
        tokens_dev = (
            plan.global_micro_batch * cfg.model.block_size / plan.device_count
        )
        n_offload = sum(1 for t in tiers if t == "offload")
        return {
            "flops": float(prof["flops"]) / plan.device_count * remat_factor,
            "bytes_accessed": float(prof["bytes_accessed"]) / plan.device_count,
            "collective_bytes": gradient_collective_bytes(
                plan.axes, grad_bytes / model_shard
            ),
            "offload_bytes": float(
                tokens_dev * cfg.model.d_model * dtype_b * 2.0 * n_offload
            ),
            "source": "lowered",
        }
    except Exception as exc:  # noqa: BLE001 — analytic fallback stands in
        logger.debug("candidate count failed: %s", exc)
        return None


def prune_candidates(
    candidates: list[Candidate],
    cfg: Any,
    *,
    device_count: int,
    caps: ModelCaps,
    peaks: Mapping[str, float],
    hbm_limit_bytes: float,
    max_probes: int,
    baseline_topology: Mapping[str, Any] | None = None,
    cost_fn: Callable[[MeshPlan], dict[str, float] | None] | None = None,
) -> dict[str, Any]:
    """The analytical pruning pass: validate, score, discard — with a
    recorded reason per discarded candidate.

    Returns ``{"survivors": [Candidate...], "pruned": [{key, reason}...],
    "enumerated": N}``.  Survivors carry their ``predicted`` block
    (roofline class, analytical ms, HBM prediction).  Ordering of
    survivors is best-predicted-first (total analytical ms ascending,
    ties by key, so the order is deterministic).

    ``baseline_topology`` (a manifest topology block) turns on the resume
    constraint: candidates the elastic matrix would reject on resume
    (model-axis or global-batch changes, resilience/elastic.py) prune as
    topology-illegal — the tune then only proposes plans a running
    checkpoint could adopt.

    ``cost_fn`` overrides the per-plan cost source (e.g. a closure over
    :func:`lowered_candidate_cost`); None falls back to the analytic
    model.  A cost_fn returning None for a plan also falls back.
    """
    m = cfg.model
    n_params = estimate_param_count(
        d_model=m.d_model,
        n_layers=m.n_layers,
        d_ff=m.d_ff,
        vocab_size=int(m.vocab_size or 50257),
        block_size=m.block_size,
        tie_embeddings=m.tie_embeddings,
        n_experts=int((m.extra or {}).get("n_experts", 0) or 0),
    )
    dtype_b = 2 if m.dtype == "bfloat16" else 4
    pdtype_b = 2 if m.param_dtype == "bfloat16" else 4
    # The HBM feasibility check must charge the logits buffer the run
    # will actually pay (dense vs chunked vs fused CE) — same resolution
    # the adapter performs at build time.
    from .plan import config_loss_impl

    loss_impl, ce_chunk = config_loss_impl(cfg)

    pruned: list[dict[str, str]] = []
    scored: list[Candidate] = []
    for cand in candidates:
        try:
            plan = resolve_plan(
                mesh_sizes=cand.mesh_sizes,
                device_count=device_count,
                caps=caps,
                micro_batch_size=cand.micro_batch_size,
                grad_accum_steps=cfg.trainer.grad_accum_steps,
                remat=cand.remat,
                zero_stage=cand.zero_stage,
                attention=cfg.model.attention,
                model_name=cfg.model.name,
                activation_tiers=cand.activation_tiers,
            )
        except MeshPlanError as exc:
            pruned.append({"key": cand.key(), "reason": f"topology-illegal: {exc}"})
            continue
        cand.plan = plan
        if baseline_topology is not None:
            try:
                classify_topology_change(
                    dict(baseline_topology), plan.describe_topology()
                )
            except TopologyMismatchError as exc:
                first = str(exc).split(":")[0]
                pruned.append(
                    {"key": cand.key(), "reason": f"topology-illegal (resume): {first}"}
                )
                continue

        cost = cost_fn(plan) if cost_fn is not None else None
        if cost is None:
            cost = analytic_candidate_cost(plan, cfg, n_params=n_params)
        roof = classify_roofline(
            flops=cost["flops"],
            bytes_accessed=cost["bytes_accessed"],
            collective_bytes=cost.get("collective_bytes", 0.0),
            peaks=peaks,
        )
        # Offload staging rides the host DMA link, a resource the
        # roofline's three peaks don't model — append it as its own
        # serial term (conservative: no overlap credit).
        offload_ms = (
            cost.get("offload_bytes", 0.0) / HOST_DMA_BYTES_PER_SEC * 1e3
        )
        predicted_ms = sum(roof["analytical_ms"].values()) + offload_ms
        hbm = predict_hbm_bytes(
            plan,
            n_params=n_params,
            d_model=m.d_model,
            n_layers=m.n_layers,
            vocab_size=int(m.vocab_size or 50257),
            block_size=m.block_size,
            dtype_bytes=dtype_b,
            param_dtype_bytes=pdtype_b,
            loss_impl=loss_impl,
            ce_chunk=ce_chunk,
        )
        # Rank on time PER TOKEN, not raw step time: candidates differ in
        # global batch, and a half-size microbatch "wins" raw step time
        # while losing throughput — exactly the bias a tuner must not have.
        tokens = plan.global_micro_batch * m.block_size
        cand.predicted = {
            "cost": cost,
            "roofline": roof,
            "predicted_step_ms": round(predicted_ms, 6),
            "predicted_us_per_token": round(predicted_ms * 1e3 / tokens, 6),
            "offload_ms": round(offload_ms, 6),
            "hbm": hbm,
            "hbm_limit_bytes": hbm_limit_bytes,
        }
        if hbm["total_bytes"] > hbm_limit_bytes:
            pruned.append(
                {
                    "key": cand.key(),
                    "reason": (
                        f"infeasible-hbm: predicted "
                        f"{hbm['total_bytes'] / 2**30:.2f} GiB per device > "
                        f"limit {hbm_limit_bytes / 2**30:.2f} GiB"
                    ),
                }
            )
            continue
        scored.append(cand)

    # Dominated-candidate pruning: A dominates B when A is no worse on
    # both predicted axes (time per token, HBM) and strictly better on one.
    scored.sort(key=lambda c: (c.predicted["predicted_us_per_token"], c.key()))
    survivors: list[Candidate] = []
    for cand in scored:
        t_c = cand.predicted["predicted_us_per_token"]
        h_c = cand.predicted["hbm"]["total_bytes"]
        dominator = next(
            (
                s
                for s in survivors
                if s.predicted["predicted_us_per_token"] <= t_c
                and s.predicted["hbm"]["total_bytes"] <= h_c
                and (
                    s.predicted["predicted_us_per_token"] < t_c
                    or s.predicted["hbm"]["total_bytes"] < h_c
                )
            ),
            None,
        )
        if dominator is not None:
            pruned.append(
                {
                    "key": cand.key(),
                    "reason": (
                        f"dominated: {dominator.key()} predicts both a "
                        "per-token time and an HBM footprint no worse "
                        f"({dominator.predicted['predicted_us_per_token']:.4f}"
                        f"us/tok vs {t_c:.4f}us/tok)"
                    ),
                }
            )
            continue
        survivors.append(cand)

    # The probe-budget cap is itself a recorded pruning reason, never a
    # silent truncation (acceptance criterion: no silent caps).
    if len(survivors) > max_probes:
        for rank, cand in enumerate(survivors[max_probes:], start=max_probes + 1):
            pruned.append(
                {
                    "key": cand.key(),
                    "reason": (
                        f"probe-budget: ranked #{rank} by predicted time "
                        f"per token; tune.max_probes is {max_probes}"
                    ),
                }
            )
        survivors = survivors[:max_probes]

    return {
        "survivors": survivors,
        "pruned": pruned,
        "enumerated": len(candidates),
    }


__all__ = [
    "Candidate",
    "DEVICE_HBM_BYTES",
    "HOST_DMA_BYTES_PER_SEC",
    "TIER_FLOPS_FACTOR",
    "analytic_candidate_cost",
    "enumerate_candidates",
    "lowered_candidate_cost",
    "prune_candidates",
    "resolve_hbm_limit",
]
