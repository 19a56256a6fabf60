"""Seeded chaos-recovery harness: repeated hard-kill → resume cycles with
machine-checked invariants (port of ``llmtrain_tpu/resilience/chaos.py``).

The atomic commit protocol (training/checkpoint.py) and elastic resume
(resilience/elastic.py) each make a local guarantee; this module is the
capstone that turns them into one provable end-to-end contract — "die
anywhere, resume, and the trajectory is the one an uninterrupted run
would have produced". It is a SUPERVISOR: every training segment is a
real ``python -m llmtrain_tpu_torch train`` subprocess, every kill a real
``SIGKILL`` delivered by the config-driven fault plan at a step drawn
from a seeded schedule (including a window forced INSIDE the async
checkpoint write via ``faults.kill_during_checkpoint``, and a cycle that
corrupts the newest committed payload to prove torn files are never
selected).

After every cycle the harness asserts:

* the newest committed checkpoint is loadable (manifest verifies, payload
  parses) — a crash can cost progress since the last commit, never the
  ability to resume;
* no torn/uncommitted checkpoint is ever selected — each segment's
  "resumed from" step equals the newest VALID commit observed before it
  launched;

and after the final (uninterrupted) cycle:

* the completed run's logged loss trajectory is bitwise-equal to an
  uninterrupted reference run's at every overlapping step, and the final
  checkpoints' params/opt_state are bitwise-identical tree-wide.

The segment/invariant machinery lives in ``resilience/harness.py``, shared
with the multi-tenant fleet storm (``fleet/chaos.py``). The uninterrupted
reference runs beside the killed segments (its own run dir; nothing of it
depends on them), as the storm runs its references. Every segment runs on
the device the config names (``run.device``): on the card the drill also
proves the kernels give the same bits in a fresh process.
"""

from __future__ import annotations

import json
import random
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import yaml

from ..utils.logging import get_logger
from .harness import (
    KILL_RETURNCODES as _KILL_RETURNCODES,
)
from .harness import (
    RESUMED_RE as _RESUMED_RE,  # noqa: F401 — re-exported for drills/tests
)
from .harness import (
    DrillInvariantError,
    aligned_log_every,
    derive_segment_config,
    next_save_boundary,
    run_train_segment,
)
from .harness import (
    assert_newest_loadable as _harness_assert_newest_loadable,
)
from .harness import (
    log_size as _log_size,
)
from .harness import (
    newest_committed_step as _newest_committed_step,
)
from .harness import (
    segment_resumed_step as _segment_resumed_step,
)
from .harness import (
    summary_of as _harness_summary_of,
)
from .harness import (
    trees_bitwise_equal as _trees_bitwise_equal,
)

logger = get_logger()


class ChaosInvariantError(DrillInvariantError):
    """A recovery invariant failed — the crash-consistency contract is
    broken (this is the harness's whole reason to exist, so it is loud)."""


def _derive_config(
    resolved: dict[str, Any],
    *,
    root_dir: str,
    max_steps: int,
    save_every: int,
    log_every: int,
    faults: dict[str, Any] | None,
) -> dict[str, Any]:
    """One chaos segment's config (harness.derive_segment_config with this
    drill's historical signature — kept because tests and docs pin it)."""
    return derive_segment_config(
        resolved,
        root_dir=root_dir,
        max_steps=max_steps,
        save_every=save_every,
        log_every=log_every,
        faults=faults,
    )


def _assert_newest_loadable(ckpt_dir: Path) -> int:
    return _harness_assert_newest_loadable(ckpt_dir, error_cls=ChaosInvariantError)


def _run_segment(cfg_path: Path, run_id: str, *, timeout_sec: float, label: str):
    return run_train_segment(
        cfg_path,
        run_id,
        timeout_sec=timeout_sec,
        label=label,
        error_cls=ChaosInvariantError,
    )


def _summary_of(proc, label: str) -> dict[str, Any]:
    return _harness_summary_of(
        proc.stdout or "",
        returncode=proc.returncode,
        stderr=proc.stderr or "",
        label=label,
        error_cls=ChaosInvariantError,
    )


def _next_save_boundary(last_step: int, save_every: int, max_steps: int) -> int | None:
    return next_save_boundary(last_step, save_every, max_steps)


def _kill_cycles(cfg, steps: int, save: int, seed: int, cycles: int, runs_root: Path,
                 write_cfg, timeout_sec: float) -> tuple[list[dict[str, Any]], Any, bool]:
    """The seeded kill schedule: ``cycles`` killed segments of the "chaos"
    run, each checked for restorability and resume selection. Returns the
    cycle records, the last segment's process and whether a segment
    completed the run."""
    rng = random.Random(f"llmtrain-chaos:{seed}")
    chaos_dir = runs_root / "chaos"
    ckpt_dir = chaos_dir / "checkpoints"
    cycle_records: list[dict[str, Any]] = []
    completed_early = False
    proc = None
    for i in range(max(1, cycles)):
        last = _newest_committed_step(ckpt_dir) if ckpt_dir.is_dir() else 0
        if last >= steps:
            completed_early = True
            break
        boundary = _next_save_boundary(last, save, steps)
        # Cycle 1 (0-based) always aims inside the async checkpoint write;
        # cycle 2 corrupts a committed payload post-write. Both degrade to
        # a plain kill when no save boundary remains before max_steps.
        if i == min(1, max(1, cycles) - 1) and boundary is not None:
            mode = "kill_during_checkpoint"
            faults = {"kill_at_step": boundary, "kill_during_checkpoint": True}
            kill_step = boundary
        elif i == 2 and boundary is not None and boundary < steps and last > 0:
            # Only once an earlier commit exists to fall back to: the
            # injection destroys the newest committed payload, and the
            # invariant under test is that selection skips it — not that a
            # run survives losing its only checkpoint.
            mode = "corrupt_then_kill"
            kill_step = rng.randint(boundary + 1, steps)
            faults = {
                "corrupt_checkpoint_at_step": boundary,
                "corrupt_mode": "truncate",
                "kill_at_step": kill_step,
            }
        else:
            mode = "kill"
            kill_step = rng.randint(last + 1, steps)
            faults = {"kill_at_step": kill_step}
        cfg_path = write_cfg(f"cycle_{i:02d}.yaml", faults)
        expected_resume = last if last > 0 else None
        log_file = chaos_dir / "logs" / cfg.logging.file_name
        log_offset = _log_size(log_file)
        proc = _run_segment(
            cfg_path, "chaos", timeout_sec=timeout_sec, label=f"cycle {i}"
        )
        record: dict[str, Any] = {
            "cycle": i,
            "mode": mode,
            "kill_step": kill_step,
            "resumed_from_expected": expected_resume,
            "returncode": proc.returncode,
        }
        if proc.returncode == 0:
            # The kill landed at/after the final step's save: the segment
            # completed. Later cycles have nothing left to kill.
            record["completed"] = True
            cycle_records.append(record)
            completed_early = True
            newest = _assert_newest_loadable(ckpt_dir)
            record["newest_committed_step"] = newest
            break
        if proc.returncode not in _KILL_RETURNCODES:
            raise ChaosInvariantError(
                f"cycle {i} exited {proc.returncode} instead of dying to "
                f"SIGKILL; stderr tail: {(proc.stderr or '')[-2000:]}"
            )
        # Invariant: restorability survived the kill.
        newest = _assert_newest_loadable(ckpt_dir)
        record["newest_committed_step"] = newest
        # Invariant: the segment resumed from the newest VALID commit
        # observed before launch — selecting a torn/uncommitted step would
        # show up right here.
        resumed = _segment_resumed_step(log_file, log_offset)
        record["resumed_from_observed"] = resumed
        if expected_resume is not None and resumed != expected_resume:
            raise ChaosInvariantError(
                f"cycle {i} resumed from step {resumed}, expected the newest "
                f"valid commit {expected_resume} — selection picked a "
                "checkpoint it should not have"
            )
        cycle_records.append(record)

    return cycle_records, proc, completed_early


def run_chaos(
    config_path: str | Path,
    *,
    cycles: int = 5,
    seed: int = 0,
    max_steps: int | None = None,
    save_every: int | None = None,
    work_dir: str | Path | None = None,
    timeout_sec: float = 600.0,
) -> dict[str, Any]:
    """Run the seeded kill/resume schedule; returns the result record.

    ``cycles`` is the number of KILLED segments (≥1; a final uninterrupted
    segment always follows). The schedule is a pure function of ``seed``
    and the observed commit progress. Raises :class:`ChaosInvariantError`
    the moment any invariant breaks.
    """
    from ..config import load_and_validate_config
    from ..training.checkpoint import CheckpointManager

    cfg, _, resolved = load_and_validate_config(str(config_path))
    steps = int(max_steps or cfg.trainer.max_steps)
    save = int(save_every or min(cfg.trainer.save_every_steps, max(1, steps // 3)))
    save = max(1, min(save, steps))
    # Interval means are only comparable when every resume point (a save
    # boundary) is also a log boundary: pick the largest log cadence that
    # divides the save cadence.
    log_every = aligned_log_every(save, cfg.trainer.log_every_steps)
    work = Path(work_dir) if work_dir is not None else Path(cfg.output.root_dir) / (
        f"chaos_{cfg.run.name}_s{seed}"
    )
    work.mkdir(parents=True, exist_ok=True)
    runs_root = work / "runs"
    if runs_root.exists():
        # The runs tree is this harness's own scratch: a rerun with the
        # same seed must start from zero, not --auto-resume last drill's
        # completed runs (which would execute 0 steps, log an empty
        # trajectory, and falsely fail the bitwise comparison).
        import shutil

        shutil.rmtree(runs_root)

    def write_cfg(name: str, faults: dict[str, Any] | None) -> Path:
        payload = _derive_config(
            resolved,
            root_dir=str(runs_root),
            max_steps=steps,
            save_every=save,
            log_every=log_every,
            faults=faults,
        )
        path = work / name
        path.write_text(yaml.safe_dump(payload, sort_keys=False), encoding="utf-8")
        return path

    # ---------------------------------------------------------- reference
    # The uninterrupted reference runs beside the kill schedule below and is
    # collected after the final segment.
    ref_cfg = write_cfg("reference.yaml", None)
    started = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        ref_future = pool.submit(
            _run_segment, ref_cfg, "reference", timeout_sec=timeout_sec, label="reference"
        )
        cycle_records, proc, completed_early = _kill_cycles(
            cfg, steps, save, seed, cycles, runs_root, write_cfg, timeout_sec
        )
        ref_proc = ref_future.result()
    if ref_proc.returncode != 0:
        raise ChaosInvariantError(
            f"uninterrupted reference run failed (exit {ref_proc.returncode}): "
            f"{(ref_proc.stderr or '')[-2000:]}"
        )
    ref_summary = _summary_of(ref_proc, "reference")
    ref_dir = runs_root / "reference"
    chaos_dir = runs_root / "chaos"
    ckpt_dir = chaos_dir / "checkpoints"

    # ----------------------------------------------------------- final run
    final_summary: dict[str, Any]
    if completed_early and cycle_records and cycle_records[-1].get("completed"):
        final_summary = _summary_of(proc, "final")
    else:
        final_cfg = write_cfg("final.yaml", None)
        final_proc = _run_segment(
            final_cfg, "chaos", timeout_sec=timeout_sec, label="final"
        )
        if final_proc.returncode != 0:
            raise ChaosInvariantError(
                f"final uninterrupted segment failed (exit "
                f"{final_proc.returncode}): {(final_proc.stderr or '')[-2000:]}"
            )
        final_summary = _summary_of(final_proc, "final")

    # --------------------------------------------------------- comparison
    ref_result = ref_summary.get("train_result") or {}
    chaos_result = final_summary.get("train_result") or {}
    mismatches: list[str] = []
    if ref_result.get("final_step") != chaos_result.get("final_step"):
        mismatches.append(
            f"final_step {chaos_result.get('final_step')} != "
            f"{ref_result.get('final_step')}"
        )
    if ref_result.get("final_loss") != chaos_result.get("final_loss"):
        mismatches.append(
            f"final_loss {chaos_result.get('final_loss')!r} != "
            f"{ref_result.get('final_loss')!r} (bitwise)"
        )

    # Loss trajectory: every interval the final segment logged must match
    # the reference bitwise at the same global step.
    overlap = 0
    try:
        ref_traj = {
            int(s): v
            for s, v in json.loads((ref_dir / "report.json").read_text())["loss"][
                "trajectory"
            ]
        }
        chaos_traj = json.loads((chaos_dir / "report.json").read_text())["loss"][
            "trajectory"
        ]
    except (OSError, KeyError, ValueError) as exc:
        mismatches.append(f"loss trajectories unreadable: {exc}")
    else:
        for s, v in chaos_traj:
            s = int(s)
            if s not in ref_traj:
                continue
            overlap += 1
            if ref_traj[s] != v:
                mismatches.append(
                    f"train/loss at step {s}: {v!r} != {ref_traj[s]!r} (bitwise)"
                )
        if overlap == 0:
            mismatches.append("no overlapping trajectory points to compare")

    # Final checkpoints: params/opt_state bitwise-identical tree-wide.
    ref_newest = CheckpointManager(ref_dir / "checkpoints").latest_valid_checkpoint()
    chaos_newest = CheckpointManager(ckpt_dir).latest_valid_checkpoint()
    if ref_newest is None or chaos_newest is None:
        mismatches.append("missing final checkpoint on one side")
    else:
        ref_payload = CheckpointManager.load(ref_newest)
        chaos_payload = CheckpointManager.load(chaos_newest)
        if int(ref_payload["step"]) != int(chaos_payload["step"]):
            mismatches.append(
                f"final checkpoint steps differ: {int(chaos_payload['step'])} "
                f"vs {int(ref_payload['step'])}"
            )
        for key in ("params", "opt_state"):
            diff = _trees_bitwise_equal(ref_payload[key], chaos_payload[key], key)
            if diff is not None:
                mismatches.append(diff)

    if mismatches:
        raise ChaosInvariantError(
            "chaos run diverged from the uninterrupted reference: "
            + "; ".join(mismatches)
        )

    # ------------------------------------------------------------- goodput
    # The wall-clock cost of all those kills, attributed post-hoc from the
    # chaos run dir's durable artifacts (telemetry/goodput.py). Two gates:
    # the ledger must BALANCE (categories sum to total wall-clock within
    # 1% — an unbalanced ledger means segments went missing), and
    # productive share must clear the configured floor.
    from ..telemetry.goodput import compute_goodput

    goodput = compute_goodput(chaos_dir)
    if goodput is not None:
        wall = goodput["wall_clock_sec"]
        attributed = sum(goodput["categories"].values())
        if wall > 0 and abs(attributed - wall) > 0.01 * wall + 0.05:
            raise ChaosInvariantError(
                f"goodput ledger does not balance: {attributed:.2f}s "
                f"attributed vs {wall:.2f}s wall-clock — segment "
                "artifacts are missing or mis-ordered"
            )
        floor = cfg.resilience.chaos.min_goodput_frac
        if goodput["goodput_frac"] < floor:
            raise ChaosInvariantError(
                f"goodput_frac {goodput['goodput_frac']:.4f} below the "
                f"configured floor resilience.chaos.min_goodput_frac="
                f"{floor:.4f} (ledger: {goodput['categories']})"
            )

    kill_cycles = [r for r in cycle_records if not r.get("completed")]
    return {
        "seed": seed,
        "max_steps": steps,
        "save_every": save,
        "log_every": log_every,
        "cycles": cycle_records,
        "kills_delivered": len(kill_cycles),
        "kill_during_checkpoint_cycles": sum(
            1 for r in cycle_records if r["mode"] == "kill_during_checkpoint"
        ),
        "trajectory_points_compared": overlap,
        "final_step": chaos_result.get("final_step"),
        "final_loss": chaos_result.get("final_loss"),
        "reference_final_loss": ref_result.get("final_loss"),
        "bitwise_match": True,
        "goodput": goodput,
        "work_dir": str(work),
        "wall_time_sec": round(time.perf_counter() - started, 2),
    }


__all__ = ["ChaosInvariantError", "run_chaos"]
