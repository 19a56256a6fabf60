"""Seeded preemption storm over the fleet: the scheduler's acceptance drill
(the port of ``llmtrain_tpu/fleet/chaos.py``).

The single-job chaos harness (resilience/chaos.py) proves "die anywhere,
resume, trajectory preserved" for one run; this drill proves the fleet
supervisor preserves that contract for EVERY tenant at once while it is
actively scheduling against them. One seeded storm delivers:

* a **scripted capacity drop** — the pool shrinks below total demand once
  every tenant has a commit, forcing shrink-to-min / suspend decisions,
  then recovers (tenants grow back through elastic resume);
* **seeded random evictions** — per-tenant in-config faults
  (``preempt_at_step`` for step-exact graceful self-preemption,
  ``kill_at_step`` for the crash-shaped eviction) plus supervisor-
  delivered external evictions through the SIGTERM→deadline→SIGKILL
  ladder;
* **one mid-checkpoint kill** — ``kill_during_checkpoint`` dies between a
  tenant's staged checkpoint files and its manifest publish, the torn
  window the atomic commit protocol exists for.

After the storm, every tenant must have COMPLETED, and for each tenant:
the logged loss trajectory is bitwise-equal to an uninterrupted
per-tenant reference at every comparable step, and the final
params/opt_state trees are bitwise-identical. The per-cycle chaos
invariants (newest commit loadable, resumed-from-newest-valid, no torn
selection) are asserted by the supervisor at every launch/reap, and
tenant device bounds are asserted at every launch.

Two measured caveats, both counted in the result rather than silently
absorbed:

* A tenant gracefully preempted MID log interval resumes from its
  preemption save, so the first interval it logs after the resume
  averages fewer steps than the reference's same-step interval. The
  per-step losses are still bitwise-identical — only that one partial
  MEAN is not comparable — so the comparison skips exactly that boundary
  (``skipped_partial_points``).
* Bitwise parity holds for tenants whose world size never changed.
  Running the SAME math on a different device count reorders the
  floating-point reductions (a different number of ranks sums the
  gradients in another order), so a
  tenant the scheduler RESIZED mid-storm is compared against its
  reference at ``resize_loss_rtol`` instead — the elastic-resume
  contract's reduction-order noise bound — and the result records which
  parity each tenant was held to. The acceptance drill uses fixed-size
  tenants (min_devices == max_devices) so every tenant is bitwise.

Driven by ``llmtrain fleet --storm`` and ``make verify-fleet``.
"""

from __future__ import annotations

import json
import random
import subprocess
import time
from pathlib import Path
from typing import Any

import yaml

from ..resilience.harness import (
    run_rank_group,
    summary_of,
    train_segment_command,
    trees_bitwise_equal,
)
from ..utils.logging import get_logger
from . import tenant as ts
from .supervisor import FleetInvariantError, FleetSupervisor, allocation_config

logger = get_logger()


def partial_interval_step(resumed_step: int | None, log_every: int) -> int | None:
    """The single log boundary whose interval mean is NOT comparable after
    a mid-interval resume: the first boundary after ``resumed_step`` when
    the resume point is not itself a boundary. None when every logged
    interval is a full window (aligned resume, or no resume at all)."""
    if not resumed_step or resumed_step % log_every == 0:
        return None
    return resumed_step + (log_every - resumed_step % log_every)


def _storm_fault_plan(
    sup: FleetSupervisor, seed: int
) -> tuple[dict[str, dict[str, Any]], str]:
    """Seeded segment-0 fault per tenant, rotating the three disruption
    shapes so a ≥3-tenant storm always contains a graceful preemption, a
    hard kill, and the mid-checkpoint kill. Steps land past the first
    save boundary so every tenant has a commit to resume from (which is
    what makes ``resume_count >= 1`` assertable per tenant)."""
    rng = random.Random(f"llmtrain-fleet-storm:{seed}")
    kinds = ("preempt", "kill_during_checkpoint", "kill")
    plan: dict[str, dict[str, Any]] = {}
    midckpt_tenant = ""
    for i, (name, t) in enumerate(sorted(sup.tenants.items())):
        kind = kinds[i % len(kinds)]
        # The fault must land after the first commit (so the respawn has
        # something to resume — the resume_count >= 1 assertion) and clear
        # of the final log interval (a disruption there leaves the
        # completing segment with ONLY the partial boundary to log — zero
        # comparable trajectory points on a correct run). A cadence with
        # no such window is a config problem, not a recovery failure:
        # reject it up front with the remediation.
        lo = t.save_every + 1
        hi = t.max_steps - t.log_every - 1
        if lo > hi:
            raise ValueError(
                f"tenant {name}: no storm-fault window between the first "
                f"save boundary ({t.save_every}) and the final log "
                f"interval (max_steps {t.max_steps}, log_every "
                f"{t.log_every}) — lower --save-every or raise --max-steps"
            )
        if kind == "preempt":
            plan[name] = {"preempt_at_step": rng.randint(lo, hi)}
        elif kind == "kill":
            plan[name] = {"kill_at_step": rng.randint(lo, hi)}
        else:
            # Die INSIDE the async write of the second save boundary: the
            # first boundary's commit is the guaranteed fallback. A cadence
            # with only one boundary would leave the killed tenant nothing
            # to resume from (falsely failing the resume_count assertion) —
            # reject it up front like the window check above.
            if 2 * t.save_every > t.max_steps:
                raise ValueError(
                    f"tenant {name}: the mid-checkpoint kill needs at least "
                    f"two save boundaries within max_steps ({t.max_steps}) "
                    f"at save_every {t.save_every} — lower --save-every or "
                    "raise --max-steps"
                )
            boundary = 2 * t.save_every
            plan[name] = {"kill_at_step": boundary, "kill_during_checkpoint": True}
            midckpt_tenant = name
    # run_fleet_storm requires >= 2 tenants, so the rotation always
    # assigned kinds[1] (the mid-checkpoint kill) to somebody.
    assert midckpt_tenant, "storm fault rotation must place the mid-ckpt kill"
    return plan, midckpt_tenant


class _StormController:
    """on_tick controller: capacity drop + external evictions, gated on
    observed commit progress so every disruption lands on a tenant that
    has something real to lose (and therefore something real to resume)."""

    def __init__(
        self,
        sup: FleetSupervisor,
        seed: int,
        *,
        drop_to: int,
        hold_sec: float,
        external_evictions: int,
        min_run_sec: float = 2.5,
    ) -> None:
        rng = random.Random(f"llmtrain-fleet-storm-ctl:{seed}")
        names = sorted(sup.tenants)
        self._hold_sec = hold_sec
        self._drop_to = drop_to
        self._dropped_at: float | None = None
        # A pool already at the drop target has no capacity cycle to run
        # (a 2-tenant pool of 1): mark the cycle done so the storm still
        # converges; the drill only asserts the cycle when one was due.
        self._restored = drop_to >= sup.capacity
        self._pool = sup.capacity
        # An external eviction waits for the target segment to be genuinely
        # mid-run (past interpreter/jax startup) so it interrupts real
        # training progress, not a process that has not restored yet.
        self._min_run_sec = min_run_sec
        # (tenant, mode) external evictions, distinct tenants first.
        picks: list[tuple[str, str]] = []
        pool = list(names)
        for _ in range(external_evictions):
            if not pool:
                pool = list(names)
            name = pool.pop(rng.randrange(len(pool)))
            picks.append((name, rng.choice(("graceful", "hard"))))
        self._evictions = picks
        self._evict_gate: dict[str, int] = {}

    def __call__(self, sup: FleetSupervisor) -> None:
        now = time.monotonic()
        # Scripted capacity drop once every tenant holds a commit.
        if not self._restored:
            if self._dropped_at is None:
                if all(sup.newest_commit(n) > 0 for n in sup.tenants):
                    sup.set_capacity(self._drop_to)
                    self._dropped_at = now
            elif now - self._dropped_at >= self._hold_sec:
                sup.set_capacity(self._pool)
                self._restored = True
        # External evictions: fire each once its tenant is running with
        # fresh commit progress since the previous disruption. Segment 0
        # is off-limits — it belongs to the tenant's seeded in-config
        # fault, and racing an external SIGKILL against an injected one
        # would make the eviction attribution (and the drill's
        # mid-checkpoint-kill assertion) nondeterministic.
        remaining: list[tuple[str, str]] = []
        for name, mode in self._evictions:
            t = sup.tenants[name]
            if t.sm.terminal:
                continue  # completed before we got to it — storm moves on
            gate = self._evict_gate.get(name, 0)
            if (
                t.sm.state == ts.RUNNING
                and len(t.segments) >= 2
                and now - t.segments[-1]["started_at"] >= self._min_run_sec
                and sup.newest_commit(name) > gate
                and sup.request_eviction(name, mode)
            ):
                self._evict_gate[name] = sup.newest_commit(name)
                logger.info(
                    "storm: external %s eviction delivered to tenant %s",
                    mode,
                    name,
                )
                continue
            remaining.append((name, mode))
        self._evictions = remaining

    @property
    def capacity_cycle_done(self) -> bool:
        return self._restored


def run_fleet_storm(
    config_path: str | Path,
    *,
    seed: int = 0,
    max_steps: int | None = None,
    save_every: int | None = None,
    work_dir: str | Path | None = None,
    timeout_sec: float = 900.0,
    step_delay_sec: float = 0.15,
    capacity_drop_hold_sec: float = 2.0,
    external_evictions: int = 2,
    resize_loss_rtol: float = 0.02,
) -> dict[str, Any]:
    """Run the seeded preemption storm; returns the result record.

    Raises :class:`FleetInvariantError` the moment any per-tenant recovery
    invariant, bounds invariant, or parity check fails. Tenants whose
    world size never changed are held to BITWISE parity; resized tenants
    to ``resize_loss_rtol`` (see module doc).
    """
    from ..config import load_and_validate_config
    from ..training.checkpoint import CheckpointManager

    cfg, _, resolved = load_and_validate_config(str(config_path))
    if len(cfg.fleet.tenants) < 2:
        raise ValueError(
            "the preemption storm needs at least 2 fleet tenants "
            f"(got {len(cfg.fleet.tenants)})"
        )
    work = (
        Path(work_dir)
        if work_dir is not None
        else Path(cfg.output.root_dir) / f"fleet_storm_{cfg.run.name}_s{seed}"
    )
    started = time.perf_counter()

    # Tenants are throttled (trainer.extra.step_delay_sec) so externally
    # delivered evictions and the capacity drop reliably land while the
    # tiny smoke models are mid-run; the throttle changes wall-clock only,
    # never the math, so references run unthrottled.
    sup = FleetSupervisor(
        cfg,
        resolved,
        work_dir=work,
        seed=seed,
        max_steps=max_steps,
        save_every=save_every,
        extra_tenant_overrides={
            "trainer": {"extra": {"step_delay_sec": step_delay_sec}}
        },
        # Drill semantics: pinned cadence + trackers off, and a rerun with
        # the same seed starts from zero — auto-resuming last drill's
        # completed tenants would log empty trajectories and falsely fail
        # the bitwise comparison.
        fresh=True,
        drill=True,
    )

    # ------------------------------------------------- per-tenant references
    # Each reference runs at the tenant's INITIAL planned allocation (the
    # deterministic full-capacity plan), so a tenant the storm never
    # resizes is bit-for-bit comparable against it.
    from .policy import plan_allocations

    initial_plan = plan_allocations(
        cfg.fleet.pool_devices, [t.demand() for t in sup.tenants.values()]
    ).allocations
    ref_allocs = {
        name: (initial_plan.get(name) or t.demand_sizes[0])
        for name, t in sup.tenants.items()
    }
    # Build the seeded fault plan BEFORE the references run: an infeasible
    # cadence must be rejected up front, not after minutes of reference
    # wall-clock.
    fault_plan, midckpt_tenant = _storm_fault_plan(sup, seed)
    refs_root = work / "refs"
    if refs_root.exists():
        import shutil

        shutil.rmtree(refs_root)
    refs_root.mkdir(parents=True, exist_ok=True)

    def run_reference(name: str) -> dict[str, Any]:
        ref_alloc = ref_allocs[name]
        ref_cfg = allocation_config(sup.tenants[name].base_config, ref_alloc)
        ref_cfg["trainer"].setdefault("extra", {})["step_delay_sec"] = 0
        ref_cfg["output"]["root_dir"] = str(refs_root)
        ref_path = work / "cfg" / f"{name}_reference.yaml"
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        ref_path.write_text(yaml.safe_dump(ref_cfg, sort_keys=False), encoding="utf-8")
        logger.info("drill: launching %s reference on %d rank(s)", name, ref_alloc)
        try:
            proc = run_rank_group(
                train_segment_command(ref_path, name),
                sup._child_envs(ref_alloc),
                timeout_sec,
            )
        except subprocess.TimeoutExpired as exc:
            raise FleetInvariantError(
                f"{name} reference segment exceeded {timeout_sec:.0f}s — a "
                "run must make progress, not wedge"
            ) from exc
        if proc.returncode != 0:
            raise FleetInvariantError(
                f"uninterrupted reference for tenant {name} failed (exit "
                f"{proc.returncode}): {(proc.stderr or '')[-2000:]}"
            )
        return summary_of(
            proc.stdout,
            returncode=proc.returncode,
            stderr=proc.stderr,
            label=f"{name} reference",
            error_cls=FleetInvariantError,
        )

    # The references are independent subprocesses with separate run dirs:
    # run them concurrently (the threads only block on child waits) — the
    # deterministic math cannot depend on host scheduling.
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(sup.tenants)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        ref_summaries: dict[str, dict[str, Any]] = dict(
            zip(names, pool.map(run_reference, names))
        )

    # ------------------------------------------------------------- the storm
    # A planned fault stays installed across respawns until it actually
    # FIRED (another storm event — a capacity-drop suspension, an external
    # eviction — may end the segment first) or until observed progress
    # makes it unfirable (the step-exact injections never re-fire on a
    # resume past their step). One-shot per tenant either way.
    pending_faults = dict(fault_plan)

    def fault_provider(name: str, segment: int) -> dict[str, Any] | None:
        t = sup.tenants[name]
        fault = pending_faults.get(name)
        if not fault:
            return None
        fired = (
            t.counts["self_preemptions"] >= 1 or t.counts["injected_kills"] >= 1
        )
        if fired:
            pending_faults.pop(name)
            return None
        if not fault.get("kill_during_checkpoint"):
            # kill_during_checkpoint aims at "the first save at/after the
            # step" and stays firable on any resumed segment; the
            # step-exact faults die once the resume point passes them.
            at = fault.get("preempt_at_step") or fault.get("kill_at_step")
            if at is not None and sup.newest_commit(name) >= at:
                pending_faults.pop(name)
                return None
        return fault

    sup._fault_provider = fault_provider
    drop_to = max(1, min(t.cfg.min_devices for t in sup.tenants.values()))
    controller = _StormController(
        sup,
        seed,
        drop_to=drop_to,
        hold_sec=capacity_drop_hold_sec,
        external_evictions=external_evictions,
    )
    fleet_report = sup.run(timeout_sec=timeout_sec, on_tick=controller)

    # ----------------------------------------------------------- assertions
    failures: list[str] = []
    not_completed = [
        n for n, v in fleet_report["tenants"].items() if v["state"] != ts.COMPLETED
    ]
    if not_completed:
        states = {
            n: fleet_report["tenants"][n]["state"] for n in not_completed
        }
        raise FleetInvariantError(f"storm left tenants unfinished: {states}")
    tenant_results: dict[str, dict[str, Any]] = {}
    for name, t in sorted(sup.tenants.items()):
        view = fleet_report["tenants"][name]
        # Bounds invariant, re-checked post-hoc over the whole history
        # (the supervisor also asserts it at every launch).
        bad = [a for a in view["allocations"] if a not in t.demand_sizes]
        if bad:
            failures.append(
                f"{name}: allocations {bad} outside feasible sizes "
                f"{list(t.demand_sizes)}"
            )
        if view["evictions"]["total"] < 1:
            failures.append(f"{name}: storm delivered no eviction")
        if view["resume_count"] < 1:
            failures.append(
                f"{name}: resume_count {view['resume_count']} — evictions "
                "did not accumulate resumes (the --auto-resume run-dir "
                "propagation is broken)"
            )

        # Parity vs the uninterrupted reference: bitwise when the world
        # size never changed, resize_loss_rtol when the scheduler resized
        # the tenant (different device counts reorder the float
        # reductions — see module doc).
        ref_alloc = ref_allocs[name]
        resized = any(a != ref_alloc for a in view["allocations"])
        rtol = resize_loss_rtol if resized else 0.0

        def loss_mismatch(got: Any, want: Any) -> bool:
            if rtol == 0.0 or got is None or want is None:
                return got != want
            return abs(float(got) - float(want)) > rtol * max(
                abs(float(want)), 1e-8
            )

        ref_result = ref_summaries[name].get("train_result") or {}
        if view["final_step"] != ref_result.get("final_step"):
            failures.append(
                f"{name}: final_step {view['final_step']} != "
                f"{ref_result.get('final_step')}"
            )
        if loss_mismatch(view["final_loss"], ref_result.get("final_loss")):
            failures.append(
                f"{name}: final_loss {view['final_loss']!r} != "
                f"{ref_result.get('final_loss')!r} "
                f"({'bitwise' if rtol == 0.0 else f'rtol {rtol}'})"
            )
        final_seg = t.segments[-1] if t.segments else {}
        skip_step = partial_interval_step(
            final_seg.get("observed_resume"), t.log_every
        )
        overlap = skipped = 0
        try:
            ref_traj = {
                int(s): v
                for s, v in json.loads(
                    (refs_root / name / "report.json").read_text()
                )["loss"]["trajectory"]
            }
            storm_traj = json.loads(
                (t.run_dir / "report.json").read_text()
            )["loss"]["trajectory"]
        except (OSError, KeyError, ValueError) as exc:
            failures.append(f"{name}: loss trajectories unreadable: {exc}")
        else:
            for s, v in storm_traj:
                s = int(s)
                if s not in ref_traj:
                    continue
                if s == skip_step:
                    skipped += 1
                    continue
                overlap += 1
                if loss_mismatch(v, ref_traj[s]):
                    failures.append(
                        f"{name}: train/loss at step {s}: {v!r} != "
                        f"{ref_traj[s]!r} "
                        f"({'bitwise' if rtol == 0.0 else f'rtol {rtol}'})"
                    )
            if overlap == 0 and skipped == 0:
                # With skipped > 0 the final segment's only logged point
                # was the one partial boundary (an external eviction can
                # land inside the final interval); the final-checkpoint
                # tree comparison below still pins correctness bitwise.
                failures.append(f"{name}: no comparable trajectory points")

        ref_newest = CheckpointManager(
            refs_root / name / "checkpoints"
        ).latest_valid_checkpoint()
        storm_newest = CheckpointManager(t.ckpt_dir).latest_valid_checkpoint()
        if ref_newest is None or storm_newest is None:
            failures.append(f"{name}: missing final checkpoint on one side")
        else:
            ref_payload = CheckpointManager.load(ref_newest)
            storm_payload = CheckpointManager.load(storm_newest)
            if int(ref_payload["step"]) != int(storm_payload["step"]):
                failures.append(
                    f"{name}: final checkpoint steps differ: "
                    f"{int(storm_payload['step'])} vs {int(ref_payload['step'])}"
                )
            if not resized:
                for key in ("params", "opt_state"):
                    diff = trees_bitwise_equal(
                        ref_payload[key], storm_payload[key], f"{name}/{key}"
                    )
                    if diff is not None:
                        failures.append(diff)
        # Goodput floor: the supervisor already attributed each tenant's
        # wall clock (suspension windows included) in _tenant_report; a
        # storm that recovers correctness but burns the clock on restart
        # churn fails here, not in a dashboard three days later.
        ledger = view.get("goodput")
        floor = cfg.resilience.chaos.min_goodput_frac
        if ledger is None:
            failures.append(f"{name}: no goodput ledger in fleet report")
        else:
            wall = float(ledger["wall_clock_sec"])
            attributed = sum(float(v) for v in ledger["categories"].values())
            if abs(attributed - wall) > 0.01 * wall + 0.05:
                failures.append(
                    f"{name}: goodput ledger does not balance: "
                    f"{attributed:.3f}s attributed vs {wall:.3f}s wall"
                )
            if floor > 0.0 and float(ledger["goodput_frac"]) < floor:
                failures.append(
                    f"{name}: goodput_frac {ledger['goodput_frac']:.4f} "
                    f"below floor {floor} "
                    f"(categories: {ledger['categories']})"
                )
        tenant_results[name] = {
            "evictions": view["evictions"],
            "respawns": view["respawns"],
            "resizes": view["resizes"],
            "resume_count": view["resume_count"],
            "segment_faults": fault_plan.get(name) or {},
            "reference_allocation": ref_alloc,
            "parity": "bitwise" if not resized else f"loss_rtol<={rtol}",
            "trajectory_points_compared": overlap,
            "skipped_partial_points": skipped,
            "final_loss": view["final_loss"],
            "goodput": ledger,
        }

    if drop_to < cfg.fleet.pool_devices and fleet_report["capacity_changes"] < 2:
        failures.append(
            "capacity drop never completed its drop/restore cycle "
            f"({fleet_report['capacity_changes']} change(s))"
        )
    if midckpt_tenant and sup.tenants[midckpt_tenant].counts["injected_kills"] < 1:
        failures.append(
            f"mid-checkpoint kill never fired on tenant {midckpt_tenant}"
        )
    if failures:
        raise FleetInvariantError(
            "fleet storm diverged from the per-tenant references: "
            + "; ".join(failures)
        )

    result = {
        "seed": seed,
        "tenants": tenant_results,
        "pool_devices": cfg.fleet.pool_devices,
        "capacity_drop_to": drop_to,
        "capacity_changes": fleet_report["capacity_changes"],
        "mid_checkpoint_kill_tenant": midckpt_tenant,
        "total_evictions": fleet_report["totals"]["evictions"],
        "total_respawns": fleet_report["totals"]["respawns"],
        "total_suspensions": fleet_report["totals"]["suspensions"],
        "fleet_goodput_frac": fleet_report["totals"].get("goodput_frac"),
        "bitwise_match": all(
            r["parity"] == "bitwise" for r in tenant_results.values()
        ),
        "fleet_report_json": str(work / "fleet_report.json"),
        "work_dir": str(work),
        "wall_time_sec": round(time.perf_counter() - started, 2),
    }
    (work / "storm_result.json").write_text(
        json.dumps(result, indent=2), encoding="utf-8"
    )
    return result


__all__ = ["partial_interval_step", "run_fleet_storm"]
