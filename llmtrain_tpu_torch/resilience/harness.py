"""Shared drill machinery for subprocess-supervising recovery harnesses
(port of ``llmtrain_tpu/resilience/harness.py``).

The single-job chaos drill (``resilience/chaos.py``, ``llmtrain chaos``)
and the multi-tenant fleet storm (``fleet/chaos.py``, ``llmtrain fleet
--storm``) prove the same crash-consistency contract at different scales:
run REAL ``python -m llmtrain_tpu_torch train`` subprocesses, interrupt them,
and machine-check that every restart resumed from the newest valid
commit and that the completed trajectory is bitwise-identical to an
uninterrupted reference. This module holds the pieces both supervisors
need — segment launching, summary parsing, commit inspection, resumed-
step log parsing, and the bitwise tree comparator — so the fleet drill
IMPORTS the invariants instead of copy-pasting them (and a fix to one
drill is automatically a fix to the other).

Every function that asserts an invariant takes an ``error_cls`` so each
harness raises its own loud, named error type (``ChaosInvariantError``,
``FleetInvariantError``) while sharing one implementation.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

from ..utils.logging import get_logger

logger = get_logger()


class DrillInvariantError(RuntimeError):
    """Base class for "a recovery invariant failed" — the contract the
    drills exist to prove is broken, so failures are loud and typed."""


# The trainer logs exactly this on restore; both drills parse it to learn
# which commit a segment actually selected at launch.
RESUMED_RE = re.compile(r"resumed from .*step_(\d{6,})\.ckpt at step (\d+)")

# SIGKILL surfaces as -9 from Popen (or 128+9 through a shell).
KILL_RETURNCODES = (-9, 137)
# SIGTERM that killed the process before the trainer's handler could turn
# it into a clean preemption exit (e.g. during interpreter startup).
TERM_RETURNCODES = (-15, 143)


def deep_merge(base: dict[str, Any], overrides: dict[str, Any]) -> dict[str, Any]:
    """Recursive dict merge (overrides win; nested dicts merge key-wise).

    Returns a new dict; neither input is mutated. Non-dict override
    values replace wholesale — a tenant overriding ``model.extra`` keeps
    the base's untouched keys, but overriding a list replaces the list.
    """
    out = dict(base)
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def derive_segment_config(
    resolved: dict[str, Any],
    *,
    root_dir: str,
    max_steps: int,
    save_every: int,
    log_every: int,
    faults: dict[str, Any] | None,
    overrides: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """One drill segment's config: the user's run, re-rooted into the
    harness work dir, with cadence pinned and the segment's fault plan
    installed. Tracker/endpoint integrations are forced off — segments
    are killed mid-flight and must not strand external state (and fleet
    tenants must not fight over one Prometheus port). ``overrides`` are
    deep-merged first (fleet tenants customize lr/LoRA/etc. this way)."""
    cfg = json.loads(json.dumps(resolved))  # deep copy, JSON-safe by construction
    if overrides:
        cfg = deep_merge(cfg, overrides)
    cfg.setdefault("output", {})["root_dir"] = root_dir
    trainer = cfg.setdefault("trainer", {})
    trainer["max_steps"] = max_steps
    trainer["save_every_steps"] = save_every
    trainer["log_every_steps"] = log_every
    # Eval adds wall-clock without touching the trajectory contract.
    trainer["eval_every_steps"] = max_steps
    cfg.setdefault("mlflow", {})["enabled"] = False
    cfg.setdefault("telemetry", {})["prometheus"] = False
    resilience = cfg.setdefault("resilience", {})
    resilience["faults"] = dict(faults or {})
    return cfg


def aligned_log_every(save_every: int, log_every: int) -> int:
    """Largest log cadence that divides the save cadence.

    Interval loss means are only comparable across a resume when every
    resume point (a save boundary) is also a log boundary; both drills
    pin their derived configs with this.
    """
    if save_every % log_every != 0:
        return save_every
    return log_every


def newest_committed_step(ckpt_dir: Path) -> int:
    """Step of the newest verifying commit, 0 when none exists.

    Full-scan semantics (the legacy per-file fallback): only call this
    when no writer owns the directory — between a drill's segments, never
    on a live run (see :func:`newest_committed_step_live`).
    """
    from ..training.checkpoint import CheckpointManager

    newest = CheckpointManager(ckpt_dir).latest_valid_checkpoint()
    if newest is None:
        return 0
    return int(newest.stem.split("_")[1])


def newest_committed_step_live(ckpt_dir: Path, *, mgr: Any = None) -> int:
    """Side-effect-free newest-commit probe, safe on a LIVE run's dir.

    The full scan (``latest_valid_checkpoint``) falls back to per-file
    verification when no manifest verifies; on a live directory a payload
    without a manifest is simply a commit in flight (payload renamed,
    manifest publish pending). This probe consults committed manifests
    ONLY: an in-flight step stays invisible until its publish, which is
    exactly the atomic-commit reading of the directory.

    Pass a reusable read-side ``mgr`` (CheckpointManager) when probing at
    a high cadence: its (path, size, mtime) verify cache then
    short-circuits re-hashing an unchanged newest payload.
    """
    if mgr is None:
        from ..training.checkpoint import CheckpointManager

        mgr = CheckpointManager(ckpt_dir)
    for path in reversed(mgr.all_manifests()):
        if mgr.verify_manifest(path):
            return int(path.stem.split("_")[1])
    return 0


def assert_newest_loadable(
    ckpt_dir: Path, *, error_cls: type[Exception] = DrillInvariantError
) -> int:
    """Invariant: the newest committed checkpoint must load. Returns its
    step (0 when the dir holds no checkpoints yet — a kill before the
    first commit costs progress, not restorability)."""
    from ..training.checkpoint import (
        CheckpointManager,
        read_manifest,
    )

    mgr = CheckpointManager(ckpt_dir)
    if not mgr.all_checkpoints() and not mgr.all_manifests():
        return 0
    newest = mgr.latest_valid_checkpoint()
    if newest is None:
        raise error_cls(
            f"checkpoints exist under {ckpt_dir} but none verifies — "
            "the run lost its ability to resume"
        )
    if read_manifest(newest) is None:
        raise error_cls(f"selected checkpoint {newest.name} has no commit manifest")
    payload = mgr.load(newest)  # raises CheckpointError on damage
    return int(payload["step"])


def log_size(log_file: Path) -> int:
    """Current byte length of a shared train.log (0 when absent) —
    recorded before a segment launches so its restore point is read from
    ITS appended region only."""
    try:
        return log_file.stat().st_size
    except OSError:
        return 0


def segment_resumed_step(log_file: Path, offset: int) -> int | None:
    """The segment's launch-time restore point: the FIRST "resumed from"
    line appended past ``offset``. First, not last — a mid-segment spike
    rollback logs the same line for its restore, and mistaking that for
    the auto-resume selection would fail the torn-selection invariant on
    a correct run."""
    try:
        with log_file.open("rb") as fh:
            fh.seek(offset)
            text = fh.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    match = RESUMED_RE.search(text)
    if match is None:
        return None
    return int(match.group(2))


def _leaf_bytes(x: Any) -> tuple[str, tuple[int, ...], Any]:
    """(dtype name, shape, numpy view) of an array leaf: numpy, a scalar,
    or a torch tensor (bfloat16 compared through its int16 bits, which
    numpy cannot hold as floats)."""
    import numpy as np

    if type(x).__module__.startswith("torch"):
        import torch

        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy()
        x = t.numpy()
    arr = np.asarray(x)
    return arr.dtype.name, arr.shape, arr


def trees_bitwise_equal(a: Any, b: Any, path: str = "") -> str | None:
    """None when the (nested dict / array) trees match bitwise; otherwise
    a human-readable path to the first mismatch."""
    import numpy as np

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)):
            return f"{path}: node/leaf structure differs"
        if sorted(a) != sorted(b):
            return f"{path}: keys differ ({sorted(a)} vs {sorted(b)})"
        for key in a:
            sub = trees_bitwise_equal(a[key], b[key], f"{path}/{key}")
            if sub is not None:
                return sub
        return None
    (da, sa, aa), (db, sb, bb) = _leaf_bytes(a), _leaf_bytes(b)
    if da != db or sa != sb:
        return f"{path}: dtype/shape differ ({da}{sa} vs {db}{sb})"
    if not np.array_equal(aa, bb, equal_nan=aa.dtype.kind in "fc"):
        return f"{path}: values differ"
    return None


def train_segment_command(cfg_path: Path | str, run_id: str) -> list[str]:
    """The real-CLI invocation both drills supervise: auto-resume so a
    respawn continues from the newest commit, --json so the summary is
    machine-parseable off stdout."""
    return [
        sys.executable,
        "-m",
        "llmtrain_tpu_torch",
        "train",
        "--config",
        str(cfg_path),
        "--run-id",
        run_id,
        "--auto-resume",
        "--json",
    ]


def run_train_segment(
    cfg_path: Path,
    run_id: str,
    *,
    timeout_sec: float,
    label: str,
    error_cls: type[Exception] = DrillInvariantError,
    env: dict[str, str] | None = None,
) -> subprocess.CompletedProcess:
    """Blocking one-segment run (the chaos drill and fleet references);
    the fleet supervisor multiplexes tenants with Popen instead."""
    cmd = train_segment_command(cfg_path, run_id)
    logger.info("drill: launching %s segment (%s)", label, cfg_path.name)
    try:
        return subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout_sec, env=env
        )
    except subprocess.TimeoutExpired as exc:
        raise error_cls(
            f"{label} segment exceeded {timeout_sec:.0f}s — a resumed run "
            "must make progress, not wedge"
        ) from exc


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pin_child_topology(env: dict[str, str], device_count: int) -> list[dict[str, str]]:
    """One child environment per rank of a ``device_count``-rank group (a
    tune probe, a fleet tenant's segment): the rank and world pinned (any
    inherited ones replaced; ``LOCAL_RANK`` r is card r) and, for several
    ranks, one rendezvous on this host; the package found from this
    checkout."""
    base = {k: v for k, v in env.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                         "JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS")}
    # The children import this package from the same checkout.
    root = str(Path(__file__).resolve().parents[2])
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if device_count == 1:
        return [base]
    port = str(free_port())
    return [{**base, "RANK": str(r), "WORLD_SIZE": str(device_count), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port} for r in range(device_count)]


def run_rank_group(cmd: list[str], envs: list[dict[str, str]],
                   timeout_sec: float) -> subprocess.CompletedProcess:
    """Run one group of ranks to its end: rank 0's result, or the first
    failing rank's. Every child is stopped before this returns."""
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


def summary_of(
    stdout: str,
    *,
    returncode: int | None,
    stderr: str = "",
    label: str,
    error_cls: type[Exception] = DrillInvariantError,
) -> dict[str, Any]:
    """Last JSON object line on a segment's stdout (the --json run
    summary); raises ``error_cls`` when a segment that should have
    completed printed none."""
    for line in reversed((stdout or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    raise error_cls(
        f"{label} segment (exit {returncode}) printed no summary JSON; "
        f"stderr tail: {(stderr or '')[-2000:]}"
    )


def next_save_boundary(last_step: int, save_every: int, max_steps: int) -> int | None:
    boundary = ((last_step // save_every) + 1) * save_every
    return boundary if boundary <= max_steps else None


__all__ = [
    "DrillInvariantError",
    "KILL_RETURNCODES",
    "RESUMED_RE",
    "TERM_RETURNCODES",
    "aligned_log_every",
    "assert_newest_loadable",
    "deep_merge",
    "derive_segment_config",
    "free_port",
    "log_size",
    "newest_committed_step",
    "newest_committed_step_live",
    "next_save_boundary",
    "pin_child_topology",
    "run_rank_group",
    "run_train_segment",
    "segment_resumed_step",
    "summary_of",
    "train_segment_command",
    "trees_bitwise_equal",
]
