"""Hang watchdog, progress beacon / heartbeat file, and straggler telemetry
(port of ``llmtrain_tpu/resilience/watchdog.py``).

Crash-shaped failures raise; *hang-shaped* failures don't. A stuck
collective, a wedged data fetch, or a straggling host stalls the whole
multi-host job without ever raising, and a Job with no liveness signal
burns accelerator time until a human notices. This module supplies the
three signals production training treats as table stakes (TorchTitan's
hang detection, MinT's self-classifying jobs — see PAPERS.md):

* :class:`ProgressBeacon` — each optimizer step records (step, monotonic
  time) and touches a heartbeat file whose mtime freshness a k8s
  ``livenessProbe`` exec can check from outside the process.
* :class:`HangWatchdog` — a daemon thread that, when no progress lands
  within ``stall_timeout_sec``, dumps every thread's stack plus the
  device's diagnostics (torch and CUDA versions, the card, the caching
  allocator's bytes, ``nvidia-smi``) to ``{report_dir}/hang_report_*.txt``
  and hard-exits
  with the *retryable* :data:`~.exit_codes.EXIT_HANG_DETECTED` so the
  orchestrator restarts the pod instead of waiting on a dead collective.
  ``os._exit`` is deliberate: a hung NCCL collective or kernel cannot be
  unwound by an exception, and a blocked main thread never reaches
  ``sys.exit``. The kernels are called through ``ctypes``, which releases
  the GIL for the call, so this thread runs while a launch blocks.
* :class:`StragglerTracker` — per-host step wall-times (allgathered by the
  trainer at log boundaries) reduced to max/median skew, with a
  persistent-straggler warning when the same host stays slowest.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..utils.logging import get_logger
from .exit_codes import EXIT_HANG_DETECTED

logger = get_logger()


class ProgressBeacon:
    """Shared (step, monotonic time) progress record + heartbeat file.

    ``touch`` is called from the training loop once per step; the watchdog
    thread reads ``age_seconds`` without taking locks on the hot path's
    behalf (a single tuple assignment is atomic under the GIL, and the
    lock only guards the compound read-modify-write of the heartbeat
    rate limit).
    """

    def __init__(
        self,
        heartbeat_path: str | Path | None = None,
        *,
        heartbeat_interval_sec: float = 1.0,
    ) -> None:
        self._heartbeat_path = Path(heartbeat_path) if heartbeat_path else None
        self._heartbeat_interval = max(0.0, heartbeat_interval_sec)
        self._lock = threading.Lock()
        self._step = 0
        self._stamp = time.monotonic()
        self._last_heartbeat = -float("inf")

    @property
    def heartbeat_path(self) -> Path | None:
        return self._heartbeat_path

    def touch(self, step: int) -> None:
        """Record progress at ``step`` and (rate-limited) touch the
        heartbeat file. Never raises: liveness reporting must not be able
        to kill the run it reports on."""
        now = time.monotonic()
        with self._lock:
            self._step = step
            self._stamp = now
            write_heartbeat = (
                self._heartbeat_path is not None
                and now - self._last_heartbeat >= self._heartbeat_interval
            )
            if write_heartbeat:
                self._last_heartbeat = now
        if write_heartbeat:
            try:
                self._heartbeat_path.parent.mkdir(parents=True, exist_ok=True)
                self._heartbeat_path.touch()
            except OSError as exc:
                logger.warning("heartbeat touch failed (%s); continuing", exc)

    def snapshot(self) -> tuple[int, float]:
        """(last recorded step, seconds since it was recorded)."""
        with self._lock:
            return self._step, time.monotonic() - self._stamp

    @property
    def age_seconds(self) -> float:
        return self.snapshot()[1]


def heartbeat_age_seconds(path: str | Path) -> float | None:
    """Seconds since the heartbeat file was last touched (wall clock), or
    None when it does not exist — the same freshness computation the k8s
    ``livenessProbe`` exec performs with ``stat``."""
    try:
        return max(0.0, time.time() - Path(path).stat().st_mtime)
    except OSError:
        return None


def _format_thread_stacks() -> str:
    """Stack traces of every live thread, with names — the payload a hang
    post-mortem actually needs (which collective, which lock, which IO)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "unknown")
        chunks.append(f"--- thread {name} (ident {ident}) ---")
        chunks.append("".join(traceback.format_stack(frame)))
    return "\n".join(chunks)


_SMI_TIMEOUT_SEC = 5.0


def _format_device_diagnostics() -> str:
    """Best-effort device snapshot: torch and CUDA versions, the card's
    name, the caching allocator's current and peak allocated bytes (host
    counters: no probe synchronises with the device, which may be the
    thing that hangs), and ``nvidia-smi`` under a timeout. Every probe is
    individually guarded: a wedged runtime may fail any of them, and the
    report must still be written."""
    lines = []
    try:
        import torch

        lines.append(f"torch {torch.__version__}, cuda {torch.version.cuda}")
        if torch.cuda.is_initialized():
            index = torch.cuda.current_device()
            try:
                lines.append(f"device {index}: {torch.cuda.get_device_name(index)}")
            except Exception as exc:  # noqa: BLE001 — each probe on its own
                lines.append(f"device name unavailable: {exc}")
            try:
                stats = torch.cuda.memory_stats(index)
                lines.append(
                    "allocated_bytes current="
                    f"{stats.get('allocated_bytes.all.current')} peak="
                    f"{stats.get('allocated_bytes.all.peak')}"
                )
            except Exception as exc:  # noqa: BLE001
                lines.append(f"memory_stats unavailable: {exc}")
        else:
            lines.append("CUDA not initialised in this process")
    except Exception as exc:  # noqa: BLE001 — report must be written regardless
        lines.append(f"torch diagnostics unavailable: {exc}")
    try:
        import subprocess

        smi = subprocess.run(["nvidia-smi"], capture_output=True, text=True,
                             timeout=_SMI_TIMEOUT_SEC)
        lines.append(f"nvidia-smi (exit {smi.returncode}):")
        lines.append(smi.stdout.rstrip() or smi.stderr.rstrip())
    except Exception as exc:  # noqa: BLE001 — absent, or wedged past the timeout
        lines.append(f"nvidia-smi unavailable: {exc}")
    return "\n".join(lines)


def write_hang_report(
    report_dir: str | Path,
    *,
    step: int,
    stall_seconds: float,
    stall_timeout_sec: float,
    process_index: int = 0,
    thread_stacks: str | None = None,
) -> Path | None:
    """Write ``hang_report_{utc}_p{rank}.txt`` with all-thread stacks and
    the device's diagnostics. The header and the stacks reach the file
    before any device probe runs, so a probe that blocks still leaves
    them. Returns the path, or None when the write itself failed (logged;
    the watchdog still exits)."""
    stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
    target = Path(report_dir) / f"hang_report_{stamp}_p{process_index}.txt"
    head = "\n".join(
        [
            f"HANG REPORT — no training progress for {stall_seconds:.1f}s "
            f"(stall_timeout_sec={stall_timeout_sec:g})",
            f"last completed dispatch: step {step}",
            f"pid {os.getpid()}, process_index {process_index}",
            "",
            "== thread stacks ==",
            thread_stacks if thread_stacks is not None else _format_thread_stacks(),
            "",
            "== device diagnostics ==",
            "",
        ]
    )
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(head, encoding="utf-8")
        with target.open("a", encoding="utf-8") as fh:
            fh.write(_format_device_diagnostics() + "\n")
        return target
    except OSError as exc:
        logger.error("failed to write hang report %s: %s", target, exc)
        return None


class HangWatchdog:
    """Daemon thread that hard-exits the process when the beacon stalls.

    ``exit_fn`` defaults to ``os._exit`` — the only exit that works when
    the main thread is blocked inside a dead collective (``sys.exit`` in a
    non-main thread only raises SystemExit in that thread, and atexit
    handlers can themselves deadlock on the wedged runtime). Tests inject
    a recording ``exit_fn`` instead.

    ``on_hang`` runs after the report is written and before the exit —
    the trainer uses it to drain-or-abandon the in-flight async checkpoint
    write with a bounded timeout; any exception it raises is logged and
    does not stop the exit.
    """

    def __init__(
        self,
        beacon: ProgressBeacon,
        *,
        stall_timeout_sec: float,
        report_dir: str | Path | None = None,
        poll_interval_sec: float | None = None,
        process_index: int = 0,
        exit_code: int = EXIT_HANG_DETECTED,
        exit_fn: Callable[[int], Any] = os._exit,
        on_hang: Callable[[], Any] | None = None,
        timeline: Any | None = None,
    ) -> None:
        if stall_timeout_sec <= 0:
            raise ValueError("stall_timeout_sec must be positive")
        self._beacon = beacon
        self._timeout = float(stall_timeout_sec)
        # Poll ~10x per timeout window so detection latency stays within
        # ~10% of the configured timeout, without busy-waiting sub-second
        # timeouts harder than needed.
        self._poll = (
            float(poll_interval_sec)
            if poll_interval_sec is not None
            else max(0.05, self._timeout / 10.0)
        )
        self._report_dir = Path(report_dir) if report_dir is not None else None
        self._process_index = process_index
        self._exit_code = exit_code
        self._exit_fn = exit_fn
        self._on_hang = on_hang
        # Optional EventTimeline flushed as the LAST act before exit_fn:
        # on_hang already flushes it, but on_hang rides the bounded worker
        # and can be abandoned wholesale when the drain wedges — this
        # direct flush is what keeps the hang's badput attributable in
        # telemetry/goodput.py even then (flush never raises by contract).
        self._timeline = timeline
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired = False
        self.report_path: Path | None = None

    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def arm(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="hang-watchdog", daemon=True
        )
        self._thread.start()
        logger.info(
            "hang watchdog armed: stall_timeout_sec=%g (retryable exit %d on stall)",
            self._timeout,
            self._exit_code,
        )

    def disarm(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=max(1.0, 2 * self._poll))
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        self.arm()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.disarm()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            step, age = self._beacon.snapshot()
            if age >= self._timeout:
                self._fire(step, age)
                return

    # Bound on the post-detection work (report write, device probes, on_hang
    # drain) before the exit proceeds regardless: every one of those can
    # block on the SAME wedged runtime/storage being diagnosed, and the
    # exit-76 guarantee outranks a complete report.
    _FIRE_WORK_TIMEOUT_SEC = 30.0

    def _fire(self, step: int, age: float) -> None:
        self.fired = True
        # Detection notice + stacks FIRST, as raw stderr writes — not via
        # logging: a FileHandler on the same wedged PVC that caused the
        # hang would block logger.critical forever (while holding the
        # logging lock), and the exit-76 guarantee outranks everything.
        # Raw stderr is pure-python and cannot touch the wedged storage.
        stacks = _format_thread_stacks()
        try:
            sys.stderr.write(
                f"HANG DETECTED: no training progress for {age:.1f}s "
                f"(timeout {self._timeout:g}s, last step {step}); dumping "
                f"stacks and exiting {self._exit_code} (retryable) so the "
                "orchestrator restarts this pod\n"
                "== hang watchdog thread stacks ==\n" + stacks + "\n"
            )
            sys.stderr.flush()
        except OSError:  # pragma: no cover - stderr gone
            pass

        def slow_work() -> None:
            # Logging lives INSIDE the bounded worker for the same reason:
            # a handler on dead storage must not hold the exit hostage.
            logger.critical(
                "HANG DETECTED: no training progress for %.1fs (timeout "
                "%gs, last step %d); exiting %d (retryable)",
                age,
                self._timeout,
                step,
                self._exit_code,
            )
            if self._report_dir is not None:
                self.report_path = write_hang_report(
                    self._report_dir,
                    step=step,
                    stall_seconds=age,
                    stall_timeout_sec=self._timeout,
                    process_index=self._process_index,
                    thread_stacks=stacks,
                )
                if self.report_path is not None:
                    logger.critical("hang report written to %s", self.report_path)
            if self._on_hang is not None:
                try:
                    self._on_hang()
                except Exception as exc:  # noqa: BLE001 — the exit must proceed
                    logger.error("watchdog on_hang hook failed: %s", exc)

        # Daemon helper + bounded join: report/diagnostics/drain get their
        # chance, but a PVC or runtime wedge cannot hold the exit hostage.
        worker = threading.Thread(
            target=slow_work, name="hang-watchdog-report", daemon=True
        )
        worker.start()
        worker.join(self._FIRE_WORK_TIMEOUT_SEC)
        if worker.is_alive():
            # Raw stderr, not logging: the worker may be blocked INSIDE a
            # logging handler, holding the lock logger.error would need.
            try:
                sys.stderr.write(
                    f"hang report/drain still blocked after "
                    f"{self._FIRE_WORK_TIMEOUT_SEC:.0f}s; exiting without it\n"
                )
                sys.stderr.flush()
            except OSError:  # pragma: no cover - stderr gone
                pass
        if self._timeline is not None:
            try:
                self._timeline.flush()
            except Exception:  # noqa: BLE001 — the exit-76 guarantee wins
                pass
        self._exit_fn(self._exit_code)


class StragglerTracker:
    """Fold per-host step wall-times into skew telemetry.

    ``observe`` takes the allgathered per-host mean step times of one log
    interval and returns a report dict; when the SAME host stays slowest
    with skew above ``skew_factor`` for ``patience`` consecutive
    intervals, ``persistent`` flips True — the trainer logs that as a
    warning (a transient GC pause or rebalance is noise; the same host
    being 2x slower every interval is a sick host).
    """

    def __init__(self, *, skew_factor: float = 2.0, patience: int = 3) -> None:
        if skew_factor <= 1.0:
            raise ValueError("skew_factor must be > 1")
        self._skew_factor = skew_factor
        self._patience = max(1, patience)
        self._streak_host: int | None = None
        self._streak = 0

    def observe(self, per_host_step_time: np.ndarray) -> dict[str, Any]:
        times = np.asarray(per_host_step_time, dtype=np.float64).reshape(-1)
        slowest = int(np.argmax(times))
        t_max = float(times[slowest])
        # Median over the OTHER hosts: on small host counts the straggler
        # itself would drag the plain median up and mask its own skew
        # (2 hosts: max/median(all) can never exceed 2 - epsilon).
        others = np.delete(times, slowest) if times.size > 1 else times
        t_med = float(np.median(others))
        skew = t_max / t_med if t_med > 0 else 1.0
        if skew >= self._skew_factor:
            self._streak = self._streak + 1 if slowest == self._streak_host else 1
            self._streak_host = slowest
        else:
            self._streak_host = None
            self._streak = 0
        return {
            "max_sec": t_max,
            "median_sec": t_med,
            "skew": skew,
            "slowest_host": slowest,
            "streak": self._streak,
            "persistent": self._streak >= self._patience,
        }


__all__ = [
    "HangWatchdog",
    "ProgressBeacon",
    "StragglerTracker",
    "heartbeat_age_seconds",
    "write_hang_report",
]
