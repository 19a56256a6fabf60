"""Checkpoint-stream watcher: durable-artifact polling, no IPC (the port's
copy of ``llmtrain_tpu/lifecycle/watch.py``).

The promotion controller learns about new checkpoints from durable files,
never from a live channel to the trainer. ``poll()`` wraps
:meth:`~..training.checkpoint.CheckpointManager.latest_valid_checkpoint`,
which is manifest-driven: a checkpoint exists the instant its
``step_N.manifest.json`` rename lands (atomic — a manifest published
mid-poll is either fully visible or not at all), and a run dir holding
only pre-manifest checkpoints is adopted by its first scan.

Training liveness comes from the watchdog heartbeat file's mtime
(resilience/watchdog.py ``heartbeat_age_seconds``, the signal the k8s
probes stat) plus ``report.json`` as the "run finished cleanly" marker.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..resilience.watchdog import heartbeat_age_seconds
from ..training.checkpoint import CheckpointManager

_STEP_RE = re.compile(r"step_(\d+)\.ckpt$")


class CheckpointWatcher:
    """Polls one training run's checkpoint dir for new committed steps."""

    def __init__(
        self,
        ckpt_dir: str | Path,
        *,
        run_dir: str | Path | None = None,
        manager: CheckpointManager | None = None,
    ) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        # Heartbeat + report.json live in the run dir; by convention the
        # checkpoint dir is {run_dir}/checkpoints.
        self.run_dir = Path(run_dir) if run_dir is not None else self.ckpt_dir.parent
        self._manager = manager or CheckpointManager(self.ckpt_dir)

    @property
    def manager(self) -> CheckpointManager:
        return self._manager

    # -------------------------------------------------------------- stream

    def poll(self, *, after_step: int = -1) -> tuple[Path, int] | None:
        """Newest committed-and-verified checkpoint with step >
        ``after_step``, or None. Intermediate commits that landed while a
        previous candidate soaked are skipped: the stream's head is always
        the best candidate."""
        ckpt = self._manager.latest_valid_checkpoint()
        if ckpt is None:
            return None
        m = _STEP_RE.search(ckpt.name)
        if m is None:
            return None
        step = int(m.group(1))
        if step <= after_step:
            return None
        return ckpt, step

    # ------------------------------------------------------------ liveness

    def training_finished(self) -> bool:
        """The trainer wrote its end-of-run report — the stream is over."""
        return (self.run_dir / "report.json").is_file()

    def heartbeat_age_sec(self) -> float | None:
        """Age of the freshest watchdog heartbeat file (``heartbeat`` or
        per-rank ``heartbeat.rN``), None when the run never wrote one."""
        try:
            paths = [
                p for p in self.run_dir.iterdir()
                if p.name == "heartbeat" or p.name.startswith("heartbeat.")
            ]
        except OSError:
            return None
        ages = [a for a in map(heartbeat_age_seconds, paths) if a is not None]
        return min(ages) if ages else None

    def training_alive(self, *, stale_sec: float) -> bool:
        """True while the trainer's heartbeat is fresher than ``stale_sec``.
        No heartbeat at all counts dead — a static dir (adopted snapshot)
        drains its head commit and then promote exits."""
        age = self.heartbeat_age_sec()
        return age is not None and age <= stale_sec


__all__ = ["CheckpointWatcher"]
