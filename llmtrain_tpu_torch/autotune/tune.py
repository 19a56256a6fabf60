"""Probe fits for ``tune`` (port of ``llmtrain_tpu/autotune/tune.py``).

The survivors of the analytic pruning (autotune/search.py) run as short
seeded training fits in subprocesses: each candidate gets ``train``
children with a derived config, a wall-clock timeout and its topology
pinned, and is scored from the run's ``report.json`` (the measured MFU of
``perf_attribution``, else of ``throughput``). The untuned config is always
probed first and is exempt from the probe cap, so the emitted winner's
measured MFU is at least the baseline's. A probe that fails is reported
with its status and never counted as a winner.

JAX pins a probe child's topology through ``XLA_FLAGS`` (its host device
count); the port's mesh is the process group, one device a rank, so a plan
over n devices runs n ``train`` children, each given ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (what
distributed/__init__.py reads), with ``distributed.enabled`` set in the
probe's config.

The emitted artifact is the original config dump with only the winning
plan's overrides merged in (probe-only knobs never leak into it),
validated before it is written, so ``train --config <emitted>`` accepts
it unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

from ..resilience.harness import deep_merge
from .plan import MeshPlan, caps_from_config, plan_from_config
from .search import enumerate_candidates, prune_candidates, resolve_hbm_limit

logger = logging.getLogger("llmtrain")

# Probe fits must finish, not train: huge cadences disable eval/save, and
# warmup is clamped to 0 so the warmup<=max_steps validator holds at tiny
# probe step counts.
_NEVER = 10**9


def _probe_overrides(
    plan: MeshPlan, *, probe_steps: int, workdir: str, run_id: str
) -> dict[str, Any]:
    return deep_merge(
        plan.config_overrides(),
        {
            "trainer": {
                "max_steps": probe_steps,
                "warmup_steps": 0,
                "log_every_steps": 1,
                "eval_every_steps": _NEVER,
                "save_every_steps": _NEVER,
            },
            "telemetry": {
                "prometheus": False,
                "report": True,
                "perf_attribution": True,
            },
            "mlflow": {"enabled": False},
            "output": {"root_dir": workdir, "run_id": run_id},
        },
    )


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pin_child_topology(env: dict[str, str], device_count: int) -> list[dict[str, str]]:
    """The plan was resolved against ``device_count`` devices: one child
    environment per rank, the rank and world pinned (any inherited ones
    replaced) and, for several ranks, one rendezvous on this host; the
    package found from this checkout."""
    base = {k: v for k, v in env.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                         "JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS")}
    # The children import this package from the same checkout.
    root = str(Path(__file__).resolve().parents[2])
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if device_count == 1:
        return [base]
    port = str(_free_port())
    return [{**base, "RANK": str(r), "WORLD_SIZE": str(device_count), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port} for r in range(device_count)]


def _run_children(cmd: list[str], envs: list[dict[str, str]],
                  timeout_sec: float) -> subprocess.CompletedProcess:
    """The probe's ranks; rank 0's result, or the first failing rank's.
    Every child is stopped before this returns."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for env in envs]
    deadline = time.monotonic() + timeout_sec
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=max(deadline - time.monotonic(), 0.001))
            results.append(subprocess.CompletedProcess(proc.args, proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = [r for r in results if r.returncode != 0]
    return failed[0] if failed else results[0]


def _run_probe(
    base_dump: dict[str, Any],
    plan: MeshPlan,
    *,
    config_cls: type,
    workdir: Path,
    run_id: str,
    probe_steps: int,
    timeout_sec: float,
    device_count: int,
) -> dict[str, Any]:
    """One candidate probe fit, its ranks in subprocesses. Returns a
    measurement record; ``status`` != "ok" carries the failure reason
    instead of a score."""
    import yaml

    record: dict[str, Any] = {"key": plan.key(), "run_id": run_id}
    if plan.activation_tiers:
        # The tier ladder, named explicitly (it is also suffixed into the
        # key) so perf_gate's tuned-plan "winner changed" notes and report
        # consumers see which activation regime the winner runs.
        record["activation_tiers"] = plan.activation_tiers
    dump = deep_merge(
        base_dump,
        _probe_overrides(
            plan, probe_steps=probe_steps, workdir=str(workdir), run_id=run_id
        ),
    )
    if device_count > 1:
        # Several devices are several ranks: the probe joins their group.
        dump = deep_merge(dump, {"distributed": {"enabled": True}})
    try:
        config_cls.model_validate(dump)
    except Exception as exc:  # pydantic.ValidationError
        record.update(status="invalid-config", reason=str(exc))
        return record

    cfg_path = workdir / f"{run_id}.yaml"
    cfg_path.write_text(yaml.safe_dump(dump, sort_keys=False))

    envs = _pin_child_topology(dict(os.environ), device_count)
    cmd = [
        sys.executable,
        "-m",
        "llmtrain_tpu_torch",
        "train",
        "--config",
        str(cfg_path),
        "--json",
    ]
    start = time.monotonic()
    try:
        proc = _run_children(cmd, envs, timeout_sec)
    except subprocess.TimeoutExpired:
        record.update(
            status="timeout",
            reason=f"probe exceeded tune.probe_timeout_sec={timeout_sec:g}",
        )
        return record
    record["probe_wall_sec"] = round(time.monotonic() - start, 3)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-3:]
        record.update(
            status="failed",
            reason=f"train exited {proc.returncode}: " + " | ".join(tail),
        )
        return record

    report_path = workdir / run_id / "report.json"
    try:
        report = json.loads(report_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        record.update(status="no-report", reason=f"{report_path}: {exc}")
        return record

    throughput = report.get("throughput") or {}
    attribution = report.get("perf_attribution") or {}
    mfu_block = attribution.get("mfu") or {}
    mfu = mfu_block.get("measured")
    if mfu is None:
        mfu = throughput.get("mfu")
    if mfu is None:
        record.update(
            status="no-score",
            reason="report.json has neither perf_attribution.mfu.measured "
            "nor throughput.mfu",
        )
        return record
    record.update(
        status="ok",
        mfu=float(mfu),
        step_time_sec=throughput.get("step_time_sec"),
        tokens_per_sec=throughput.get("tokens_per_sec"),
        roofline_class=attribution.get("roofline", {}).get("class"),
        mfu_reconciled=mfu_block.get("reconciled"),
        mfu_ratio=mfu_block.get("ratio_analytical_over_measured"),
    )
    return record


def local_device_count(cfg: Any) -> int:
    """The cards this host offers a config (one process each), 1 on the CPU."""
    import torch

    if cfg.run.device == "cpu" or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def _slug(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", key)


def run_tune(
    cfg: Any,
    base_dump: dict[str, Any],
    *,
    workdir: str | Path,
    output_path: str | Path,
    device_count: int | None = None,
) -> dict[str, Any]:
    """The full tune: enumerate -> prune analytically -> probe survivors
    -> emit the winner as a loadable config at ``output_path``.

    ``base_dump`` is the resolved-but-unmodified config dict (what
    ``cfg.model_dump()`` or the loader produced); the emitted YAML is
    this dump plus the winning plan's overrides only. Returns the tune
    report (also written to ``{workdir}/tune_report.json``) — it lists
    every enumerated candidate's fate: pruned (with reason), measured
    (with score), or budget-skipped. No silent caps.
    """
    from ..registry import get_model_adapter, initialize_registries
    from ..telemetry.profiling import resolve_peaks

    started = time.monotonic()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    config_cls = type(cfg)

    if device_count is None:
        device_count = local_device_count(cfg)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)
    caps = caps_from_config(cfg, adapter=adapter)
    peaks = resolve_peaks(None, cfg.telemetry.device_peaks)
    device_kind = str(peaks.get("device_kind", "cpu"))
    tune_cfg = cfg.tune
    seed = tune_cfg.seed if tune_cfg.seed is not None else cfg.run.seed
    hbm_limit = resolve_hbm_limit(device_kind, tune_cfg.hbm_limit_bytes)

    baseline_plan = plan_from_config(cfg, device_count, adapter=adapter)
    candidates = enumerate_candidates(
        cfg,
        device_count,
        seed=seed,
        microbatch_candidates=tune_cfg.microbatch_candidates,
        search_mesh=tune_cfg.search_mesh,
        search_remat=tune_cfg.search_remat,
        search_zero=tune_cfg.search_zero,
    )
    pruning = prune_candidates(
        candidates,
        cfg,
        device_count=device_count,
        caps=caps,
        peaks=peaks,
        hbm_limit_bytes=hbm_limit,
        max_probes=tune_cfg.max_probes,
        baseline_topology=(
            baseline_plan.describe_topology() if tune_cfg.preserve_topology else None
        ),
    )
    survivors = pruning["survivors"]
    logger.info(
        "tune: %d candidates enumerated, %d pruned analytically, "
        "%d survivors to probe (+ baseline)",
        pruning["enumerated"],
        len(pruning["pruned"]),
        len(survivors),
    )

    # Baseline first, always, and exempt from the probe cap: the winner's
    # measured MFU can then never fall below the untuned config's.
    deadline = started + tune_cfg.budget_sec
    measured: list[dict[str, Any]] = []
    baseline_record = _run_probe(
        base_dump,
        baseline_plan,
        config_cls=config_cls,
        workdir=workdir,
        run_id="probe_baseline",
        probe_steps=tune_cfg.probe_steps,
        timeout_sec=tune_cfg.probe_timeout_sec,
        device_count=device_count,
    )
    baseline_record["baseline"] = True
    measured.append(baseline_record)

    probed_keys = {baseline_plan.key()}
    for idx, cand in enumerate(survivors):
        plan = cand.plan
        assert plan is not None
        if plan.key() in probed_keys:
            measured.append(
                {
                    "key": plan.key(),
                    "status": "deduplicated",
                    "reason": "identical to an already-probed plan",
                    "predicted": cand.predicted.get("predicted_step_ms"),
                }
            )
            continue
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            measured.append(
                {
                    "key": plan.key(),
                    "status": "budget-skipped",
                    "reason": f"tune.budget_sec={tune_cfg.budget_sec:g} exhausted",
                }
            )
            continue
        probed_keys.add(plan.key())
        record = _run_probe(
            base_dump,
            plan,
            config_cls=config_cls,
            workdir=workdir,
            run_id=f"probe_{idx:02d}_{_slug(plan.key())}",
            probe_steps=tune_cfg.probe_steps,
            timeout_sec=min(tune_cfg.probe_timeout_sec, remaining),
            device_count=device_count,
        )
        record["predicted_step_ms"] = cand.predicted.get("predicted_step_ms")
        measured.append(record)

    scored = [m for m in measured if m.get("status") == "ok"]
    plans_by_key = {baseline_plan.key(): baseline_plan}
    for cand in survivors:
        if cand.plan is not None:
            plans_by_key.setdefault(cand.plan.key(), cand.plan)
    if scored:
        winner_record = max(
            scored,
            key=lambda m: (m["mfu"], -(m.get("step_time_sec") or float("inf"))),
        )
        winner_plan = plans_by_key[winner_record["key"]]
    else:
        # Nothing measured successfully (budget 0, broken backend...):
        # fall back to the baseline plan so the emitted config is still
        # legal and equivalent to the input.
        winner_record = {"key": baseline_plan.key(), "status": "fallback-baseline"}
        winner_plan = baseline_plan

    emitted = deep_merge(base_dump, winner_plan.config_overrides())
    config_cls.model_validate(emitted)
    import yaml

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(yaml.safe_dump(emitted, sort_keys=False))

    report = {
        "device_count": device_count,
        "device_kind": device_kind,
        "seed": seed,
        "hbm_limit_bytes": hbm_limit,
        "enumerated": pruning["enumerated"],
        "pruned": pruning["pruned"],
        "survivors": [c.plan.key() for c in survivors if c.plan is not None],
        "measured": measured,
        "baseline": baseline_record,
        "winner": winner_record,
        "output_config": str(output_path),
        "elapsed_sec": round(time.monotonic() - started, 3),
        "budget_sec": tune_cfg.budget_sec,
    }
    (workdir / "tune_report.json").write_text(json.dumps(report, indent=2))
    return report


__all__ = ["local_device_count", "run_tune"]
