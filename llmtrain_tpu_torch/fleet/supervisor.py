"""Multi-tenant fleet supervisor: N training jobs on one bounded device pool
(the port of ``llmtrain_tpu/fleet/supervisor.py``).

The chaos harness proves ONE job survives kills; this supervisor is the
control plane that makes preemption a *scheduling decision* across many
jobs (MinT, PAPERS.md). A tenant's allocation is a number of RANKS: a
segment at allocation n is n ``python -m llmtrain_tpu_torch train
--auto-resume`` subprocesses with a stable run id and ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
pinned (inherited ones replaced), one process group over gloo on the CPU
or NCCL on the card (``LOCAL_RANK`` r is card r; tenants may share a
card). ``run.device: cpu`` runs the pool on the CPU, any other device on
the card; a tenant whose ``max_devices`` exceeds the cards present is a
``ValueError`` at construction. The deterministic policy
(fleet/policy.py) decides world sizes, and every resize/suspend/evict
rides the machinery the chaos drill proved correct:

* **Graceful-first escalation ladder** — SIGTERM to every rank (the
  trainer's clean preemption save, exit 0) → ``fleet.preempt_grace_sec``
  deadline → SIGKILL of the whole group. Either way the atomic
  manifest-commit protocol guarantees the next segment resumes from a
  valid commit; the supervisor ASSERTS that (newest-commit-loadable +
  resumed-from-newest-valid, the chaos invariants promoted to
  per-tenant, via resilience/harness.py).
* **Elastic resize** — capacity shifts re-launch a tenant with
  ``micro_batch_size`` scaled inversely to its new world size, so the
  resume is an elastic topology change (resilience/elastic.py) and the
  trajectory is preserved.
* **Seeded respawn backoff** — eviction ``k`` of a tenant sleeps a
  full-jitter delay drawn from ``retry_rng(seed, tenant_index)``
  (resilience/faults.py): deterministic per tenant, decorrelated across
  tenants.
* **Degrade, never crash** — when the pool shrinks below total demand,
  low-priority tenants shrink to ``min_devices`` and then SUSPEND
  (allocation 0, waiting on capacity, not on a timer).

Health aggregates into ``llmtrain_fleet_*`` gauges (telemetry registry +
Prometheus textfile/endpoint) and a ``fleet_report.json``/``.md`` with
per-tenant resume/eviction counts, exit-code taxonomy, and heartbeat
staleness read from the watchdog beacon files. See docs/robustness.md
"Fleet: many tenants, shared capacity".
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from collections import Counter
from contextlib import ExitStack
from pathlib import Path
from typing import Any, Callable

import yaml

from ..config.schemas import FleetTenantConfig, RunConfig
from ..resilience.exit_codes import RETRYABLE_EXIT_CODES
from ..resilience.faults import retry_rng
from ..resilience.harness import (
    KILL_RETURNCODES,
    TERM_RETURNCODES,
    DrillInvariantError,
    aligned_log_every,
    assert_newest_loadable,
    derive_segment_config,
    log_size,
    newest_committed_step_live,
    pin_child_topology,
    segment_resumed_step,
    summary_of,
    train_segment_command,
)
from ..resilience.watchdog import heartbeat_age_seconds
from ..telemetry.prometheus import (
    federate_prometheus,
    render_prometheus,
    write_textfile,
)
from ..telemetry.registry import MetricsRegistry
from ..utils.logging import get_logger
from . import tenant as ts
from .policy import (
    TenantDemand,
    candidate_world_sizes,
    plan_allocations,
    priority_order,
    within_bounds,
)
from .tenant import TenantStateMachine

logger = get_logger()


class FleetInvariantError(DrillInvariantError):
    """A fleet-level recovery/scheduling invariant failed — a tenant ran
    outside its bounds, resumed from the wrong commit, or wedged."""


class _RankGroup:
    """A segment's ranks behind the one ``Popen`` surface the supervisor
    uses (``poll``, ``returncode``, ``send_signal``, ``kill``, ``wait``).

    The first rank seen failing fixes the group's exit code, and the
    survivors are killed at once: they would only wait in a collective
    for the rank that is gone. With no failure the code is rank 0's."""

    def __init__(self, procs: list[subprocess.Popen]) -> None:
        self.procs = procs
        self.returncode: int | None = None
        self.failed_rank: int | None = None

    def poll(self) -> int | None:
        if self.returncode is not None:
            return self.returncode
        codes = [p.poll() for p in self.procs]
        if self.failed_rank is None:
            self.failed_rank = next(
                (r for r, c in enumerate(codes) if c not in (None, 0)), None
            )
            if self.failed_rank is not None:
                self.kill()
        if any(c is None for c in codes):
            return None
        rank = self.failed_rank if self.failed_rank is not None else 0
        self.returncode = codes[rank]
        return self.returncode

    def send_signal(self, sig: int) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def wait(self, timeout: float | None = None) -> int | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in self.procs:
            p.wait(None if deadline is None else max(0.0, deadline - time.monotonic()))
        return self.poll()


def allocation_config(base_config: dict[str, Any], allocation: int) -> dict[str, Any]:
    """A tenant's config at ``allocation`` ranks: the elastic contract keeps
    ``micro_batch_size`` x world size constant, and several ranks join one
    process group."""
    cfg = json.loads(json.dumps(base_config))
    cfg["trainer"]["micro_batch_size"] = (
        int(base_config["trainer"].get("micro_batch_size", 8)) // allocation
    )
    cfg.setdefault("distributed", {})["enabled"] = allocation > 1
    return cfg


class _Tenant:
    """Supervisor-side runtime record for one tenant."""

    def __init__(
        self,
        index: int,
        cfg: FleetTenantConfig,
        base_config: dict[str, Any],
        *,
        seed: int,
        runs_root: Path,
        log_file_name: str,
    ) -> None:
        self.index = index
        self.cfg = cfg
        self.name = cfg.name
        self.base_config = base_config  # derived dict, cadence already pinned
        # The tenant's GLOBAL micro-batch, quoted at world size 1 (the
        # schema default when the config omits it): every launch divides
        # it by the granted world size so the elastic contract holds.
        self.global_micro = int(base_config["trainer"].get("micro_batch_size", 8))
        self.max_steps = int(base_config["trainer"]["max_steps"])
        self.save_every = int(base_config["trainer"]["save_every_steps"])
        self.log_every = int(base_config["trainer"]["log_every_steps"])
        self.demand_sizes = candidate_world_sizes(
            self.global_micro, cfg.min_devices, cfg.max_devices
        )
        self.sm = TenantStateMachine(cfg.name)
        self.run_dir = runs_root / cfg.name
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.log_file = self.run_dir / "logs" / log_file_name
        # Seeded per-tenant backoff stream: deterministic respawn delays
        # per tenant, decorrelated across tenants (the retry_rng contract).
        self.rng = retry_rng(seed, index)
        self.proc: _RankGroup | None = None
        self.out_path: Path | None = None
        self.err_path: Path | None = None
        self.allocation = 0
        self.segments: list[dict[str, Any]] = []
        self.counts: Counter = Counter()
        self.exit_codes: list[int] = []
        # Allocation-0 windows in WALL-CLOCK time (time.time(), not
        # monotonic — the goodput ledger intersects them with timeline
        # segment boundaries, which are unix stamps). The state machine's
        # history records transitions without timestamps on purpose, so
        # the supervisor tracks the windows itself.
        self.suspension_windows: list[tuple[float, float]] = []
        self.suspended_since: float | None = None
        self.next_spawn_at = 0.0
        self.kill_deadline: float | None = None
        self.hard_evict_requested = False
        # Why the in-flight preemption was started: "evict" counts toward
        # the eviction metrics and the backoff ladder; "resize"/"suspend"
        # are routine scheduling moves and must not.
        self.preempt_kind = "evict"
        self.final_summary: dict[str, Any] | None = None
        # Lazily-built READ-side checkpoint manager for high-cadence
        # newest-commit probes: reusing one instance lets its
        # (path, size, mtime) verify cache skip re-hashing an unchanged
        # newest payload on every reconcile tick.
        self._probe_mgr: Any = None

    def probe_manager(self) -> Any:
        if self._probe_mgr is None:
            from ..training.checkpoint import CheckpointManager

            self._probe_mgr = CheckpointManager(self.ckpt_dir)
        return self._probe_mgr

    # ------------------------------------------------------------- queries

    def demand(self) -> TenantDemand:
        return TenantDemand(
            name=self.name,
            priority=self.cfg.priority,
            candidate_sizes=self.demand_sizes,
            runnable=not self.sm.terminal,
        )

    def live_allocation(self) -> int:
        """Ranks this tenant's processes currently occupy (a preempting
        group still holds them until it is reaped)."""
        return self.allocation if self.proc is not None else 0

    def heartbeat_age(self) -> float | None:
        hb = self.run_dir / "heartbeat"
        return heartbeat_age_seconds(hb) if hb.exists() else None

    def close_suspension(self) -> None:
        """Close the open allocation-0 window (tenant relaunching, or the
        report is being finalized)."""
        if self.suspended_since is not None:
            self.suspension_windows.append((self.suspended_since, time.time()))
            self.suspended_since = None

    def all_suspension_windows(self) -> list[tuple[float, float]]:
        """Closed windows plus the still-open one, if any, up to now."""
        out = list(self.suspension_windows)
        if self.suspended_since is not None:
            out.append((self.suspended_since, time.time()))
        return out

    def evictions_total(self) -> int:
        return (
            self.counts["evictions_graceful"]
            + self.counts["evictions_hard"]
            + self.counts["self_preemptions"]
            + self.counts["injected_kills"]
        )


class FleetSupervisor:
    """Schedules, preempts, resizes, and heals a fleet of train subprocesses.

    ``fault_provider(tenant_name, segment_index) -> dict | None`` lets the
    storm drill (fleet/chaos.py) install seeded in-config faults
    (``preempt_at_step``, ``kill_at_step``, ``kill_during_checkpoint``)
    into specific segments; production use leaves it None.
    """

    def __init__(
        self,
        cfg: RunConfig,
        resolved: dict[str, Any],
        *,
        work_dir: str | Path,
        seed: int = 0,
        max_steps: int | None = None,
        save_every: int | None = None,
        fault_provider: Callable[[str, int], dict[str, Any] | None] | None = None,
        extra_tenant_overrides: dict[str, Any] | None = None,
        fresh: bool = False,
        drill: bool = False,
    ) -> None:
        if not cfg.fleet.tenants:
            raise ValueError(
                "fleet mode needs at least one tenant under fleet.tenants "
                "(see configs/presets/gpt_fleet_smoke.yaml)"
            )
        if cfg.run.device != "cpu":
            # A tenant's ranks sit on distinct cards: two NCCL ranks of one
            # group on one card would fail inside NCCL, so it fails here.
            import torch

            cards = torch.cuda.device_count()
            widest = max(cfg.fleet.tenants, key=lambda t: t.max_devices)
            if widest.max_devices > cards:
                raise ValueError(
                    f"fleet tenant {widest.name!r} may take "
                    f"{widest.max_devices} rank(s), one card each, but "
                    f"{cards} card(s) are present (run.device: "
                    f"{cfg.run.device}); lower its max_devices or set "
                    "run.device: cpu"
                )
        self._cfg = cfg
        self._fleet = cfg.fleet
        self._seed = seed
        self._fault_provider = fault_provider
        self._capacity = cfg.fleet.pool_devices
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._cfg_dir = self.work_dir / "cfg"
        self._seg_dir = self.work_dir / "segments"
        self._runs_root = self.work_dir / "runs"
        if fresh and self._runs_root.exists():
            # fresh=True is DRILL semantics (the storm re-runs from zero,
            # not from last drill's completed tenants). The production
            # default is False: a supervisor restart (k8s Job retry, OOM)
            # must NOT destroy tenants' committed checkpoints — every
            # tenant auto-resumes from its newest commit instead.
            import shutil

            shutil.rmtree(self._runs_root)
        for d in (self._cfg_dir, self._seg_dir, self._runs_root):
            d.mkdir(parents=True, exist_ok=True)

        self.metrics = MetricsRegistry(None)
        self._capacity_changes: list[tuple[float, int]] = []
        self._started_at: float | None = None
        self._endpoint = None
        self._last_textfile_write = 0.0
        # Fleet event timeline: launch/preempt/escalate instants land in
        # work_dir/telemetry/timeline.jsonl so ``llmtrain trace`` can line
        # supervisor disruptions up against serving and promote traces.
        self.timeline: Any = None
        try:
            from ..telemetry.timeline import EventTimeline

            tel_dir = self.work_dir / "telemetry"
            tel_dir.mkdir(parents=True, exist_ok=True)
            self.timeline = EventTimeline(tel_dir / "timeline.jsonl")
        except Exception:  # noqa: BLE001 — telemetry must not block launch
            self.timeline = None

        self.tenants: dict[str, _Tenant] = {}
        for i, tcfg in enumerate(cfg.fleet.tenants):
            base = self._derive_tenant_base(
                resolved,
                tcfg,
                max_steps=max_steps,
                save_every=save_every,
                extra_overrides=extra_tenant_overrides,
                drill=drill,
            )
            self.tenants[tcfg.name] = _Tenant(
                i,
                tcfg,
                base,
                seed=seed,
                runs_root=self._runs_root,
                log_file_name=base.get("logging", {}).get("file_name", "train.log"),
            )

    # ------------------------------------------------------------- derive

    def _derive_tenant_base(
        self,
        resolved: dict[str, Any],
        tcfg: FleetTenantConfig,
        *,
        max_steps: int | None,
        save_every: int | None,
        extra_overrides: dict[str, Any] | None,
        drill: bool = False,
    ) -> dict[str, Any]:
        """The tenant's world-size-independent config: base run + tenant
        overrides, fleet section stripped, output re-rooted, watchdog
        heartbeat enabled for the fleet health view, Prometheus off (every
        tenant binding one port would race it — the FLEET owns /metrics).

        Drill semantics (``drill=True``, or an explicit max_steps /
        save_every override) additionally pin the cadence so resume points
        align with log boundaries (the bitwise-trajectory precondition),
        push eval to the end, and disable trackers — segments get killed
        mid-flight and must not strand external state. A plain production
        ``llmtrain fleet`` run keeps each tenant's own save/eval cadence
        and tracker config untouched."""
        from ..resilience.harness import deep_merge

        pin = drill or max_steps is not None or save_every is not None
        base = dict(resolved)
        base.pop("fleet", None)
        overrides = dict(tcfg.overrides)
        if extra_overrides:
            overrides = deep_merge(overrides, extra_overrides)
        merged = deep_merge(base, overrides)
        trainer = merged.get("trainer", {})
        steps = int(max_steps or trainer.get("max_steps", 100))
        if pin:
            save = int(
                save_every
                or min(trainer.get("save_every_steps", steps), max(1, steps // 3))
            )
            save = max(1, min(save, steps))
            log_every = aligned_log_every(
                save, int(trainer.get("log_every_steps", 1))
            )
        else:
            save = int(trainer.get("save_every_steps", steps))
            log_every = int(trainer.get("log_every_steps", 1))
        derived = derive_segment_config(
            merged,
            root_dir=str(self._runs_root),
            max_steps=steps,
            save_every=save,
            log_every=log_every,
            faults=None,
        )
        if not pin:
            # Production tenants keep their configured eval cadence and
            # tracker; the drill derive disabled them above.
            derived["trainer"]["eval_every_steps"] = int(
                trainer.get("eval_every_steps", steps)
            )
            derived["mlflow"]["enabled"] = bool(
                (merged.get("mlflow") or {}).get("enabled", True)
            )
        # The fleet health view reads each tenant's watchdog beacon file;
        # the resume-selection invariant reads its train.log — and the
        # "resumed from ... at step N" line it parses is logged at INFO,
        # so the level is pinned (a WARNING-level tenant would suppress it
        # and fail the invariant on a correct resume).
        logging_cfg = derived.setdefault("logging", {})
        logging_cfg["log_to_file"] = True
        logging_cfg["level"] = "INFO"
        wd = derived.setdefault("resilience", {}).setdefault("watchdog", {})
        wd["enabled"] = True
        wd.setdefault("heartbeat_interval_sec", 0.2)
        return derived

    # ------------------------------------------------------------ plumbing

    def _child_envs(self, allocation: int) -> list[dict[str, str]]:
        """One env per rank of an ``allocation``-rank segment: the rank,
        world, card and rendezvous pinned, inherited ones REPLACED — the
        supervisor's own topology must never leak into a tenant."""
        return pin_child_topology(dict(os.environ), allocation)

    def _write_segment_cfg(
        self, t: _Tenant, segment: int, allocation: int, faults: dict[str, Any] | None
    ) -> Path:
        cfg = allocation_config(t.base_config, allocation)
        cfg["resilience"]["faults"] = dict(faults or {})
        path = self._cfg_dir / f"{t.name}_seg{segment:03d}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf-8")
        return path

    def devices_in_use(self) -> int:
        return sum(t.live_allocation() for t in self.tenants.values())

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, devices: int) -> None:
        """Capacity shift (maintenance, a preemptible slice vanishing...):
        the next reconcile shrinks/suspends/regrows tenants to match."""
        if devices < 0:
            raise ValueError(f"capacity must be >= 0, got {devices}")
        if devices != self._capacity:
            logger.info(
                "fleet: capacity %d -> %d devices", self._capacity, devices
            )
            self._capacity = devices
            self._capacity_changes.append((time.monotonic(), devices))
            self.metrics.inc("fleet/capacity_changes")

    def request_eviction(self, name: str, mode: str = "graceful") -> bool:
        """Storm/operator-driven eviction of a running tenant. ``graceful``
        starts the SIGTERM→deadline→SIGKILL ladder; ``hard`` is an
        immediate SIGKILL (the crash-shaped eviction). Returns False when
        the tenant is not currently running."""
        t = self.tenants[name]
        if t.proc is None or t.sm.state != ts.RUNNING:
            return False
        if mode == "hard":
            t.hard_evict_requested = True
            t.proc.kill()
            logger.warning("fleet: hard-evicting tenant %s (SIGKILL)", name)
        else:
            self._preempt(t, reason="evict")
        return True

    # ------------------------------------------------------------ lifecycle

    def _launch(self, t: _Tenant, allocation: int) -> None:
        if not within_bounds(allocation, t.demand()) or allocation == 0:
            raise FleetInvariantError(
                f"tenant {t.name}: allocation {allocation} outside its "
                f"feasible sizes {t.demand_sizes} — the scheduler tried to "
                "run a tenant beyond its [min_devices, quota] bounds"
            )
        segment = len(t.segments)
        faults = (
            self._fault_provider(t.name, segment) if self._fault_provider else None
        )
        cfg_path = self._write_segment_cfg(t, segment, allocation, faults)
        # Per-tenant invariant (the chaos contract): BEFORE every respawn
        # the newest commit must load, and the segment must then resume
        # from exactly that step.
        expected_resume = (
            assert_newest_loadable(t.ckpt_dir, error_cls=FleetInvariantError)
            if t.ckpt_dir.is_dir()
            else 0
        )
        record: dict[str, Any] = {
            "segment": segment,
            "allocation": allocation,
            "faults": dict(faults or {}),
            "expected_resume": expected_resume,
            "log_offset": log_size(t.log_file),
            "started_at": time.monotonic(),
        }
        # Rank 0 prints the run summary; the other ranks log beside it.
        stem = f"{t.name}_seg{segment:03d}"
        t.out_path, t.err_path = self._seg_dir / f"{stem}.out", self._seg_dir / f"{stem}.err"
        cmd = train_segment_command(cfg_path, t.name)
        procs = []
        with ExitStack() as files:
            for rank, env in enumerate(self._child_envs(allocation)):
                name = stem if rank == 0 else f"{stem}.r{rank}"
                out = files.enter_context((self._seg_dir / f"{name}.out").open("wb"))
                err = files.enter_context((self._seg_dir / f"{name}.err").open("wb"))
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, env=env))
        t.proc = _RankGroup(procs)
        if segment > 0:
            t.counts["respawns"] += 1
            self.metrics.inc("fleet/respawns")
        if t.allocation and allocation != t.allocation:
            t.counts["resizes"] += 1
            self.metrics.inc("fleet/resizes")
        t.allocation = allocation
        t.hard_evict_requested = False
        t.kill_deadline = None
        t.segments.append(record)
        t.sm.transition(ts.RUNNING, f"segment {segment} on {allocation} device(s)")
        self._fleet_instant(
            "fleet/launch",
            tenant=t.name,
            segment=segment,
            allocation=allocation,
            resume_step=expected_resume,
        )
        logger.info(
            "fleet: tenant %s segment %d launched on %d device(s)%s",
            t.name,
            segment,
            allocation,
            f" (resume from step {expected_resume})" if expected_resume else "",
        )

    def _fleet_instant(self, name: str, **args: Any) -> None:
        """Timeline instant + periodic flush, never raising: the
        supervisor's control loop must not die to a full disk."""
        if self.timeline is None:
            return
        try:
            self.timeline.instant(name, cat="fleet", **args)
            self.timeline.flush()
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def _preempt(self, t: _Tenant, *, reason: str, kind: str = "evict") -> None:
        """Rung 1 of the escalation ladder: SIGTERM → the trainer's clean
        preemption save; the reconcile loop hard-kills past the deadline."""
        if t.proc is None:
            return
        t.preempt_kind = kind
        t.sm.transition(ts.PREEMPTING, reason)
        t.kill_deadline = time.monotonic() + self._fleet.preempt_grace_sec
        try:
            t.proc.send_signal(signal.SIGTERM)
        except OSError:  # already gone; the reaper will classify it
            pass
        self._fleet_instant(
            "fleet/preempt", tenant=t.name, reason=reason, kind=kind
        )
        logger.info("fleet: preempting tenant %s (%s)", t.name, reason)

    def _escalate_overdue(self, now: float) -> None:
        for t in self.tenants.values():
            if (
                t.sm.state == ts.PREEMPTING
                and t.proc is not None
                and t.kill_deadline is not None
                and now > t.kill_deadline
            ):
                logger.warning(
                    "fleet: tenant %s ignored SIGTERM for %.1fs — escalating "
                    "to SIGKILL",
                    t.name,
                    self._fleet.preempt_grace_sec,
                )
                t.counts["escalations"] += 1
                self.metrics.inc("fleet/escalations")
                t.proc.kill()
                t.kill_deadline = None
                self._fleet_instant(
                    "fleet/escalate",
                    tenant=t.name,
                    grace_sec=self._fleet.preempt_grace_sec,
                )

    def _backoff_delay(self, t: _Tenant) -> float:
        # Every disruption escalates the ladder — retryable exits (75/76)
        # included, or a hang-looping tenant would hammer the pool at the
        # base delay until its respawn budget ran out.
        attempt = max(1, self._disruptions(t))
        cap = min(
            self._fleet.respawn_backoff_max_sec,
            self._fleet.respawn_backoff_base_sec * (2 ** (attempt - 1)),
        )
        return t.rng.uniform(0.0, cap)

    # ------------------------------------------------------------- reaping

    def _reap(self, t: _Tenant) -> None:
        """Classify a finished segment, check the per-tenant recovery
        invariants, and route the tenant to its next state."""
        proc = t.proc
        assert proc is not None
        rc = proc.returncode
        t.proc = None
        t.exit_codes.append(rc)
        record = t.segments[-1]
        record["returncode"] = rc
        record["wall_sec"] = round(time.monotonic() - record["started_at"], 2)
        stdout = t.out_path.read_text(errors="replace") if t.out_path else ""
        err_path = t.err_path
        if err_path is not None and proc.failed_rank:
            record["failed_rank"] = proc.failed_rank
            err_path = err_path.with_name(
                err_path.name.replace(".err", f".r{proc.failed_rank}.err")
            )
        stderr = err_path.read_text(errors="replace") if err_path else ""
        was_preempting = t.sm.state == ts.PREEMPTING

        # Invariant 1: restorability survived whatever ended the segment.
        if t.ckpt_dir.is_dir():
            record["newest_committed_step"] = assert_newest_loadable(
                t.ckpt_dir, error_cls=FleetInvariantError
            )
        # Invariant 2: the segment resumed from the newest valid commit
        # observed at launch — a torn/uncommitted selection fails here.
        # A segment that died BEFORE logging its restore point (eviction
        # during interpreter startup: rc != 0, nothing logged) selected
        # nothing, so the invariant is vacuous for it — but a segment that
        # ran (exit 0, or far enough to log) must show exactly the
        # expected step.
        observed = segment_resumed_step(t.log_file, record["log_offset"])
        record["observed_resume"] = observed
        expected = record["expected_resume"]
        # No check when expected == 0: a fresh segment can still log a
        # "resumed from" line legitimately — a spike rollback restores a
        # checkpoint the segment committed itself mid-run.
        if observed is None and expected > 0 and rc != 0:
            record["died_before_resume"] = True
            t.counts["preresume_deaths"] += 1
        elif expected > 0 and observed != expected:
            raise FleetInvariantError(
                f"tenant {t.name} segment {record['segment']} resumed from "
                f"step {observed}, expected the newest valid commit "
                f"{expected} — selection picked a checkpoint it should not "
                "have"
            )

        faults = record.get("faults") or {}
        if rc == 0:
            summary = summary_of(
                stdout,
                returncode=rc,
                stderr=stderr,
                label=f"tenant {t.name} segment {record['segment']}",
                error_cls=FleetInvariantError,
            )
            record["summary"] = summary
            result = summary.get("train_result") or {}
            if result.get("preempted"):
                record["preempted"] = True
                if was_preempting and t.preempt_kind != "evict":
                    # Routine scheduling moves (resize/suspend) are not
                    # evictions: they have their own counters and must
                    # not escalate the respawn-backoff ladder.
                    t.counts[f"preemptions_{t.preempt_kind}"] += 1
                elif was_preempting:
                    t.counts["evictions_graceful"] += 1
                    self.metrics.inc("fleet/evictions")
                elif "preempt_at_step" in faults or "sigterm_at_step" in faults:
                    t.counts["self_preemptions"] += 1
                    self.metrics.inc("fleet/evictions")
                else:  # an external SIGTERM we did not send (pod drain...)
                    t.counts["evictions_graceful"] += 1
                    self.metrics.inc("fleet/evictions")
                self._to_backoff(t, "preempted cleanly")
            elif int(result.get("final_step") or 0) >= t.max_steps:
                record["completed"] = True
                t.final_summary = summary
                t.sm.transition(ts.COMPLETED, f"exit 0 at step {result.get('final_step')}")
                logger.info(
                    "fleet: tenant %s COMPLETED (final_loss=%s, %d eviction(s), "
                    "%d respawn(s))",
                    t.name,
                    result.get("final_loss"),
                    t.evictions_total(),
                    t.counts["respawns"],
                )
            else:
                t.sm.transition(
                    ts.FAILED,
                    f"exit 0 at step {result.get('final_step')} before "
                    f"max_steps {t.max_steps}",
                )
        elif rc in KILL_RETURNCODES:
            if was_preempting and t.preempt_kind != "evict":
                t.counts[f"preemptions_{t.preempt_kind}"] += 1
                t.counts["escalated_preemptions"] += 1
            elif was_preempting:
                t.counts["evictions_hard"] += 1  # ladder escalated
                self.metrics.inc("fleet/evictions")
            elif t.hard_evict_requested:
                t.counts["evictions_hard"] += 1
                self.metrics.inc("fleet/evictions")
            elif "kill_at_step" in faults or faults.get("kill_during_checkpoint"):
                t.counts["injected_kills"] += 1
                self.metrics.inc("fleet/evictions")
            else:
                t.counts["crashes"] += 1
                self.metrics.inc("fleet/crashes")
            self._to_backoff(t, f"killed (exit {rc})")
        elif rc in TERM_RETURNCODES:
            # SIGTERM landed before the trainer could turn it into a clean
            # preemption exit (interpreter startup, early init): the commit
            # protocol still guarantees the respawn, it just cost progress.
            if was_preempting and t.preempt_kind != "evict":
                t.counts[f"preemptions_{t.preempt_kind}"] += 1
            elif was_preempting:
                t.counts["evictions_hard"] += 1
                self.metrics.inc("fleet/evictions")
            else:
                t.counts["crashes"] += 1
                self.metrics.inc("fleet/crashes")
            self._to_backoff(t, f"SIGTERM died uncleanly (exit {rc})")
        elif rc in RETRYABLE_EXIT_CODES:
            t.counts["retryable_exits"] += 1
            self.metrics.inc("fleet/retryable_exits")
            self._to_backoff(t, f"retryable exit {rc}")
        else:
            t.sm.transition(ts.FAILED, f"fatal exit {rc}")
            logger.error(
                "fleet: tenant %s FAILED (exit %d); stderr tail: %s",
                t.name,
                rc,
                stderr[-1000:],
            )

    def _disruptions(self, t: _Tenant) -> int:
        """Real disruptions (evictions + crashes + retryable exits) — the
        measure behind both the backoff ladder and the crash-loop budget.
        Scheduler-initiated resize/suspend relaunches are routine moves
        and count toward neither: a healthy tenant on a capacity-flapping
        pool must never be failed for the scheduler's own churn."""
        return (
            t.evictions_total()
            + t.counts["crashes"]
            + t.counts["retryable_exits"]
        )

    def _to_backoff(self, t: _Tenant, reason: str) -> None:
        if self._disruptions(t) >= self._fleet.max_respawns_per_tenant:
            t.sm.transition(
                ts.FAILED,
                f"respawn budget ({self._fleet.max_respawns_per_tenant}) "
                "exhausted",
            )
            return
        delay = self._backoff_delay(t)
        t.next_spawn_at = time.monotonic() + delay
        t.sm.transition(ts.BACKOFF, f"{reason}; respawn in {delay:.2f}s")

    # ------------------------------------------------------------ the loop

    def _reconcile(self, now: float) -> None:
        plan = plan_allocations(
            self._capacity, [t.demand() for t in self.tenants.values()]
        )
        targets = plan.allocations
        order = priority_order(
            [t.demand() for t in self.tenants.values() if not t.sm.terminal]
        )
        for d in order:
            t = self.tenants[d.name]
            target = targets.get(t.name, 0)
            state = t.sm.state
            if state == ts.RUNNING and target != t.allocation:
                self._preempt(
                    t,
                    reason=(
                        f"resize {t.allocation} -> {target}"
                        if target
                        else "pool shrank below demand — suspending"
                    ),
                    kind="resize" if target else "suspend",
                )
            elif state == ts.BACKOFF:
                if target == 0:
                    t.counts["suspensions"] += 1
                    self.metrics.inc("fleet/suspensions")
                    t.suspended_since = time.time()
                    t.sm.transition(ts.SUSPENDED, "no capacity granted")
                elif now >= t.next_spawn_at and self._fits(t, target):
                    self._launch(t, target)
            elif state == ts.SUSPENDED:
                # next_spawn_at still applies: capacity returning must not
                # relaunch every suspended tenant in the same tick — the
                # per-tenant jitter schedule survives the suspension.
                if (
                    target > 0
                    and now >= t.next_spawn_at
                    and self._fits(t, target)
                ):
                    t.close_suspension()
                    self._launch(t, target)
            elif state == ts.QUEUED:
                if target > 0 and self._fits(t, target):
                    self._launch(t, target)

    def _fits(self, t: _Tenant, target: int) -> bool:
        """Never launch beyond capacity: devices freed by a preempting
        tenant only become launchable once its process is reaped."""
        return self.devices_in_use() - t.live_allocation() + target <= self._capacity

    def _check_segment_timeouts(self, now: float) -> None:
        for t in self.tenants.values():
            if t.proc is None or not t.segments:
                continue
            started = t.segments[-1]["started_at"]
            if now - started > self._fleet.segment_timeout_sec:
                t.proc.kill()
                t.proc.wait(timeout=10)
                raise FleetInvariantError(
                    f"tenant {t.name} segment {len(t.segments) - 1} exceeded "
                    f"{self._fleet.segment_timeout_sec:.0f}s — a scheduled "
                    "tenant must make progress, not wedge"
                )

    def _render_metrics(self) -> str:
        """One rendering of the fleet's Prometheus view — the /metrics
        endpoint, the textfile snapshot, and the final flush all serve
        exactly this, so the three transports cannot diverge.

        The fleet's own gauges come first; below them, every tenant's
        textfile snapshot (``{run_dir}/telemetry/metrics.prom``, written
        by the tenant's Telemetry flush) is federated in with a
        ``tenant="<name>"`` label, so one scrape of the supervisor covers
        the whole fleet without per-tenant service discovery."""
        own = render_prometheus(
            self.metrics.latest(),
            self.metrics.counters(),
            info={"run_name": self._cfg.run.name, "mode": "fleet"},
        )
        sources: dict[str, str] = {}
        for t in self.tenants.values():
            prom = t.run_dir / "telemetry" / "metrics.prom"
            try:
                sources[t.name] = prom.read_text(encoding="utf-8")
            except OSError:
                continue  # tenant not started yet / already cleaned up
        federated = federate_prometheus(sources)
        return own + federated if federated else own

    def _publish_metrics(self) -> None:
        states = Counter(t.sm.state for t in self.tenants.values())
        now = time.monotonic()
        stale = 0
        for t in self.tenants.values():
            if t.sm.state != ts.RUNNING or not t.segments:
                continue
            age = t.heartbeat_age()
            if age is None:
                # No beacon file at all: healthy during startup, but a
                # tenant that has run past the staleness window without
                # EVER heartbeating is exactly the hung-from-birth case
                # this gauge exists to surface.
                running_for = now - t.segments[-1]["started_at"]
                if running_for > self._fleet.heartbeat_stale_sec:
                    stale += 1
            elif age > self._fleet.heartbeat_stale_sec:
                stale += 1
        self.metrics.publish(
            {
                "fleet/pool_devices": float(self._capacity),
                "fleet/devices_in_use": float(self.devices_in_use()),
                "fleet/tenants_running": float(
                    states[ts.RUNNING] + states[ts.PREEMPTING]
                ),
                "fleet/tenants_suspended": float(states[ts.SUSPENDED]),
                "fleet/tenants_backoff": float(states[ts.BACKOFF]),
                "fleet/tenants_completed": float(states[ts.COMPLETED]),
                "fleet/tenants_failed": float(states[ts.FAILED]),
                "fleet/heartbeat_stale": float(stale),
            }
        )
        # Gauges update in-memory every tick; the textfile (a full render
        # + atomic tmp/rename on the runs volume) follows the PR-4 "one
        # flush per interval" spirit — scrapers poll in seconds, not at
        # the 10 Hz reconcile cadence.
        if now - self._last_textfile_write >= 1.0:
            self._last_textfile_write = now
            write_textfile(
                self.work_dir / "fleet_metrics.prom", self._render_metrics()
            )

    def run(
        self,
        *,
        timeout_sec: float = 1800.0,
        on_tick: Callable[["FleetSupervisor"], None] | None = None,
    ) -> dict[str, Any]:
        """Drive the fleet until every tenant is terminal; returns (and
        writes) the fleet report. ``on_tick`` is the storm drill's hook —
        it may shift capacity and request evictions between reconciles."""
        self._started_at = time.monotonic()
        deadline = self._started_at + timeout_sec
        if self._cfg.telemetry.prometheus:
            from ..telemetry.prometheus import PrometheusEndpoint

            try:
                self._endpoint = PrometheusEndpoint(
                    self._render_metrics,
                    host=self._cfg.telemetry.prometheus_host,
                    port=self._cfg.telemetry.prometheus_port,
                )
                logger.info(
                    "fleet: /metrics endpoint on port %d", self._endpoint.port
                )
            except OSError as exc:
                logger.warning("fleet: /metrics endpoint unavailable (%s)", exc)
        try:
            while not all(t.sm.terminal for t in self.tenants.values()):
                now = time.monotonic()
                if now > deadline:
                    raise FleetInvariantError(
                        f"fleet did not converge within {timeout_sec:.0f}s: "
                        + ", ".join(
                            f"{t.name}={t.sm.state}" for t in self.tenants.values()
                        )
                    )
                for t in self.tenants.values():
                    if t.proc is not None and t.proc.poll() is not None:
                        self._reap(t)
                self._check_segment_timeouts(now)
                self._escalate_overdue(now)
                self._reconcile(now)
                self._publish_metrics()
                if on_tick is not None:
                    on_tick(self)
                time.sleep(self._fleet.tick_sec)
            return self.finalize()
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        for t in self.tenants.values():
            if t.proc is not None:
                t.proc.kill()
                try:
                    t.proc.wait(timeout=10)
                except Exception:  # noqa: BLE001 — teardown must not raise
                    pass
                t.proc = None
        if self._endpoint is not None:
            self._endpoint.close()
            self._endpoint = None
        if self.timeline is not None:
            try:
                self.timeline.flush()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass

    # -------------------------------------------------------------- report

    def newest_commit(self, name: str) -> int:
        """Newest COMMITTED step for a tenant — manifest-only and
        side-effect-free, because callers (the storm controller, health
        views) probe tenants whose writer is alive mid-commit."""
        t = self.tenants[name]
        if not t.ckpt_dir.is_dir():
            return 0
        return newest_committed_step_live(t.ckpt_dir, mgr=t.probe_manager())

    def _tenant_report(self, t: _Tenant) -> dict[str, Any]:
        result = (t.final_summary or {}).get("train_result") or {}
        report_path = t.run_dir / "report.json"
        resume_count = 0
        if report_path.is_file():
            try:
                resil = json.loads(report_path.read_text()).get("resilience") or {}
                resume_count = int(resil.get("resume_count", 0))
            except (OSError, ValueError):
                pass
        hb = t.heartbeat_age()
        # Per-tenant goodput ledger over the tenant's OWN durable run-dir
        # artifacts, with the supervisor's wall-clock allocation-0 windows
        # carved out of restart_overhead as `suspended` — the PR-8
        # eviction/respawn/suspension COUNTS become seconds here.
        goodput: dict[str, Any] | None = None
        try:
            from ..telemetry.goodput import compute_goodput

            goodput = compute_goodput(
                t.run_dir, suspensions=t.all_suspension_windows()
            )
        except Exception as exc:  # noqa: BLE001 — reporting must not fail the fleet
            logger.warning("fleet: goodput ledger for %s failed: %s", t.name, exc)
        return {
            "goodput": goodput,
            "state": t.sm.state,
            "priority": t.cfg.priority,
            "min_devices": t.cfg.min_devices,
            "max_devices": t.cfg.max_devices,
            "feasible_world_sizes": list(t.demand_sizes),
            "segments": len(t.segments),
            "allocations": [s["allocation"] for s in t.segments],
            "evictions": {
                "graceful": t.counts["evictions_graceful"],
                "hard": t.counts["evictions_hard"],
                "self_preempt": t.counts["self_preemptions"],
                "injected_kill": t.counts["injected_kills"],
                "total": t.evictions_total(),
            },
            "escalations": t.counts["escalations"],
            "scheduling_preemptions": {
                "resize": t.counts["preemptions_resize"],
                "suspend": t.counts["preemptions_suspend"],
                "escalated": t.counts["escalated_preemptions"],
            },
            "respawns": t.counts["respawns"],
            "resizes": t.counts["resizes"],
            "suspensions": t.counts["suspensions"],
            "crashes": t.counts["crashes"],
            "retryable_exits": t.counts["retryable_exits"],
            "exit_codes": list(t.exit_codes),
            "resume_count": resume_count,
            "final_step": result.get("final_step"),
            "final_loss": result.get("final_loss"),
            "heartbeat_age_sec": round(hb, 3) if hb is not None else None,
            "report_json": str(report_path) if report_path.is_file() else None,
            "history": [list(h) for h in t.sm.history],
        }

    def finalize(self) -> dict[str, Any]:
        """Aggregate the fleet view and write fleet_report.json/.md."""
        tenants = {
            name: self._tenant_report(t) for name, t in self.tenants.items()
        }
        wall = (
            round(time.monotonic() - self._started_at, 2)
            if self._started_at is not None
            else 0.0
        )
        report = {
            "pool_devices": self._fleet.pool_devices,
            "final_capacity": self._capacity,
            "capacity_changes": len(self._capacity_changes),
            "seed": self._seed,
            "wall_time_sec": wall,
            "tenants": tenants,
            "totals": {
                "evictions": sum(v["evictions"]["total"] for v in tenants.values()),
                "escalations": sum(v["escalations"] for v in tenants.values()),
                "respawns": sum(v["respawns"] for v in tenants.values()),
                "resizes": sum(v["resizes"] for v in tenants.values()),
                "suspensions": sum(v["suspensions"] for v in tenants.values()),
                "crashes": sum(v["crashes"] for v in tenants.values()),
                "completed": sum(
                    1 for v in tenants.values() if v["state"] == ts.COMPLETED
                ),
                "failed": sum(
                    1 for v in tenants.values() if v["state"] == ts.FAILED
                ),
            },
        }
        # Fleet-wide goodput: second-weighted across tenants (sum of
        # productive seconds over sum of wall seconds), not a mean of
        # per-tenant fractions — a tiny tenant must not swing the fleet.
        ledgers = [
            v["goodput"] for v in tenants.values() if v.get("goodput")
        ]
        goodput_totals: dict[str, float] = {}
        for ledger in ledgers:
            for cat, sec in ledger["categories"].items():
                goodput_totals[cat] = round(
                    goodput_totals.get(cat, 0.0) + float(sec), 3
                )
        fleet_wall = sum(float(x["wall_clock_sec"]) for x in ledgers)
        fleet_frac = (
            goodput_totals.get("productive_train", 0.0) / fleet_wall
            if fleet_wall > 0
            else 0.0
        )
        report["totals"]["goodput_sec"] = goodput_totals
        report["totals"]["goodput_wall_clock_sec"] = round(fleet_wall, 3)
        report["totals"]["goodput_frac"] = round(fleet_frac, 6)
        self.metrics.publish(
            {
                "fleet/goodput_frac": fleet_frac,
                "fleet/goodput_wall_clock_sec": fleet_wall,
                **{
                    f"fleet/goodput_{cat}_sec": sec
                    for cat, sec in goodput_totals.items()
                },
            }
        )
        # Final metrics snapshot, unthrottled: the textfile a collector
        # reads after the run must reflect the terminal state.
        write_textfile(
            self.work_dir / "fleet_metrics.prom", self._render_metrics()
        )
        (self.work_dir / "fleet_report.json").write_text(
            json.dumps(report, indent=2), encoding="utf-8"
        )
        (self.work_dir / "fleet_report.md").write_text(
            render_fleet_report_md(report), encoding="utf-8"
        )
        return report


def render_fleet_report_md(report: dict[str, Any]) -> str:
    """Human-readable twin of fleet_report.json."""
    lines = [
        "# Fleet report",
        "",
        f"- pool: {report['pool_devices']} device(s), "
        f"{report['capacity_changes']} capacity change(s)",
        f"- wall time: {report['wall_time_sec']}s (seed {report['seed']})",
        f"- tenants: {len(report['tenants'])} "
        f"({report['totals']['completed']} completed, "
        f"{report['totals']['failed']} failed)",
        f"- evictions: {report['totals']['evictions']} "
        f"(escalated to SIGKILL: {report['totals']['escalations']}), "
        f"respawns: {report['totals']['respawns']}, "
        f"resizes: {report['totals']['resizes']}, "
        f"suspensions: {report['totals']['suspensions']}",
    ]
    if "goodput_frac" in report["totals"]:
        lines.append(
            f"- fleet goodput: {report['totals']['goodput_frac']:.1%} of "
            f"{report['totals']['goodput_wall_clock_sec']}s tenant "
            "wall-clock (second-weighted)"
        )
    lines += [
        "",
        "| tenant | state | prio | devices | segs | evict | respawn | "
        "resume_count | final_step | final_loss | goodput |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name in sorted(report["tenants"]):
        v = report["tenants"][name]
        ledger = v.get("goodput") or {}
        goodput = (
            f"{ledger['goodput_frac']:.1%}" if ledger else "n/a"
        )
        lines.append(
            f"| {name} | {v['state']} | {v['priority']} | "
            f"[{v['min_devices']},{v['max_devices']}] | {v['segments']} | "
            f"{v['evictions']['total']} | {v['respawns']} | "
            f"{v['resume_count']} | {v['final_step']} | {v['final_loss']} | "
            f"{goodput} |"
        )
    return "\n".join(lines) + "\n"


__all__ = ["FleetInvariantError", "FleetSupervisor", "render_fleet_report_md"]
