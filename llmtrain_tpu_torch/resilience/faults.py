"""Config-driven fault injection + exponential-backoff retry (port of
``llmtrain_tpu/resilience/faults.py``; it imports no JAX, but the port
keeps its own copy).

Recovery code that is never executed is recovery code that does not work.
This module turns every failure mode the resilience layer claims to survive
into a deterministic, config-driven injection so tier-1 tests (and chaos
drills on real clusters) exercise the ACTUAL recovery paths end to end:

* ``nan_loss_at_step`` — applied inside the train step (see
  ``training/train_step.py``): loss and grads are poisoned with NaN for a
  window of optimizer steps, driving the real non-finite guard.
* ``spike_loss_at_step`` — one-shot host-side scaling of the observed loss,
  driving the real spike detector → checkpoint rollback. One-shot by
  design: the replayed step after the rollback must not re-spike.
* ``sigterm_at_step`` / ``preempt_at_step`` — ``os.kill(os.getpid(),
  SIGTERM)``, driving the real preemption handler, durable save, and clean
  exit. ``preempt_at_step`` is the preemption-named twin the fleet storm
  schedule uses (fleet/chaos.py); they share one one-shot delivery slot.
* ``kill_at_step`` / ``kill_during_checkpoint`` — ``SIGKILL``, i.e. a real
  crash with zero cleanup; the during-checkpoint variant dies between a
  save's staged files and its manifest publish, driving the atomic-commit
  protocol and the chaos harness (resilience/chaos.py).
* ``corrupt_checkpoint_at_step`` — truncates or garbles the newest
  checkpoint file on disk after its save, driving sidecar verification,
  ``latest_valid_checkpoint`` backward scan, and prune protection.
* ``dataset_load_failures`` / ``distributed_init_failures`` — make the
  first N attempts raise :class:`InjectedFault`, driving the
  :func:`retry` wiring in the trainer and CLI.

Everything defaults to "inject nothing"; a default-constructed plan is a
set of cheap no-op calls in the trainer loop.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Any, Callable, TypeVar

from ..config.schemas import FaultInjectionConfig
from ..utils.logging import get_logger

logger = get_logger()

T = TypeVar("T")


class InjectedFault(RuntimeError):
    """The exception every injected flaky-operation failure raises —
    distinct from real errors so tests can assert the injection fired."""


def retry(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 5.0,
    description: str = "operation",
    exceptions: tuple[type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    jitter: bool = True,
    rng: random.Random | None = None,
) -> T:
    """Run ``fn`` with full-jitter exponential backoff.

    Attempt ``k`` sleeps ``uniform(0, min(max_delay, base·2^(k-1)))`` —
    AWS-style FULL jitter, not a fixed ladder: when a shared dependency
    (HF hub, the rendezvous coordinator, NFS) hiccups, every host's retry
    clock starts at the same moment, and deterministic delays march the
    whole fleet back in lockstep as a thundering herd. Jitter decorrelates
    them. Pass a seeded ``rng`` for reproducible schedules (the trainer
    and CLI seed theirs from ``(run.seed, process index)`` so delays are
    deterministic per rank but different across ranks); ``jitter=False``
    restores the fixed base, 2·base, 4·base ladder. The final failure
    re-raises the original exception unchanged so callers' error handling
    (CLI exit codes, test asserts) sees the real cause, not a retry
    wrapper.
    """
    if jitter and rng is None:
        # OS-entropy seeded: still decorrelated across hosts when the
        # caller doesn't thread a seed through.
        rng = random.Random()
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except exceptions as exc:
            if attempt == attempts:
                raise
            cap = min(max_delay, base_delay * (2 ** (attempt - 1)))
            delay = rng.uniform(0.0, cap) if jitter else cap
            logger.warning(
                "%s failed (attempt %d/%d: %s); retrying in %.2fs",
                description,
                attempt,
                attempts,
                exc,
                delay,
            )
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retry_rng(seed: int, process_index: int = 0) -> random.Random:
    """Seeded backoff-jitter RNG: deterministic per (seed, rank) — tests
    can pin the exact delays — while different ranks draw different
    schedules, which is the whole anti-thundering-herd point."""
    return random.Random(f"llmtrain-retry:{seed}:{process_index}")


class FaultPlan:
    """Mutable one-shot bookkeeping over a frozen FaultInjectionConfig."""

    def __init__(self, cfg: FaultInjectionConfig | None) -> None:
        self._cfg = cfg or FaultInjectionConfig()
        self._sigterm_fired = False
        self._corrupt_fired = False
        self._spike_fired = False
        self._hang_fired = False
        self._kill_taken = False
        self._flaky_counts: dict[str, int] = {}
        # Telemetry hook: called as observer(kind, step) right before an
        # injection fires, so fired faults land on the run's event
        # timeline. Best-effort — a broken observer never blocks the
        # injection (chaos drills measure the REAL recovery path).
        self.observer: Callable[[str, int], None] | None = None

    def _notify(self, kind: str, step: int) -> None:
        if self.observer is None:
            return
        try:
            self.observer(kind, step)
        except Exception:  # noqa: BLE001 — telemetry must not alter the drill
            pass

    @classmethod
    def from_config(cls, cfg: FaultInjectionConfig | None) -> "FaultPlan":
        return cls(cfg)

    # ----------------------------------------------------------- train step

    def nan_window(self) -> tuple[int, int] | None:
        """(first poisoned optimizer step, window length) for the train
        step, or None when NaN injection is off."""
        if self._cfg.nan_loss_at_step is None:
            return None
        return (self._cfg.nan_loss_at_step, self._cfg.nan_loss_steps)

    # ------------------------------------------------------------ host side

    def maybe_sigterm(self, step: int) -> None:
        """Deliver SIGTERM to ourselves once, at EXACTLY the configured step
        — through the real OS signal path so the trainer's preemption
        handler (and nothing else) turns it into a durable save. Exact
        equality, not >=: a resumed run starting past the step must not
        re-fire the injection. ``preempt_at_step`` is the same delivery
        with the preemption-shaped name (the schema forbids setting both);
        the telemetry instant is tagged with whichever knob fired."""
        kind = "sigterm"
        at = self._cfg.sigterm_at_step
        if at is None:
            at = self._cfg.preempt_at_step
            kind = "preempt"
        if at is None or self._sigterm_fired or step != at:
            return
        self._sigterm_fired = True
        self._notify(kind, step)
        logger.warning("fault injection: delivering SIGTERM at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)

    def maybe_kill(self, step: int) -> None:
        """SIGKILL ourselves at EXACTLY the configured step — the
        hardest-possible crash: no Python handler runs, no drain, no
        preemption save. What survives on disk is whatever the atomic
        commit protocol already published; the chaos harness
        (resilience/chaos.py) asserts resume works from exactly that.
        With ``kill_during_checkpoint`` set, the kill belongs to the
        checkpoint writer instead (see :meth:`take_checkpoint_kill`) and
        this step-loop call never fires. Exact equality, not >=: a
        resumed run starting past the step must not re-fire."""
        at = self._cfg.kill_at_step
        if at is None or self._cfg.kill_during_checkpoint or step != at:
            return
        self._notify("kill", step)
        logger.warning("fault injection: delivering SIGKILL at step %d", step)
        os.kill(os.getpid(), signal.SIGKILL)

    def take_checkpoint_kill(self, step: int) -> bool:
        """True exactly once, for the save whose async write should die
        mid-commit (``kill_during_checkpoint``): the first save at/after
        ``kill_at_step`` (or the first save at all when unset). The
        checkpoint manager performs the actual SIGKILL between its staged
        files and the manifest publish — inside the write, on the writer
        thread, while the step loop runs on."""
        if not self._cfg.kill_during_checkpoint or self._kill_taken:
            return False
        at = self._cfg.kill_at_step
        if at is not None and step < at:
            return False
        self._kill_taken = True
        self._notify("kill_during_checkpoint", step)
        return True

    def maybe_hang(self, step: int, *, site: str = "host") -> None:
        """Block the calling thread FOR REAL at exactly the configured step
        (one-shot). No exception, no signal — the genuinely hang-shaped
        failure mode: from outside, the process is alive and doing nothing,
        which is exactly what the watchdog (resilience/watchdog.py) must
        detect and kill. With ``hang_duration_sec`` set the thread resumes
        afterwards (a controllable straggler stand-in); without it the
        block is indefinite and only the watchdog's ``os._exit`` (or the
        pod's liveness probe) ends the process. Exact equality, not >=:
        a resumed run starting past the step must not re-hang.

        ``site`` selects where the injection fires: the trainer's step
        loop calls with "host" (the default), the batch prefetcher's
        assembly thread with "prefetcher"; ``hang_in_prefetcher`` in the
        config picks which call actually blocks — a prefetcher hang
        starves the consumer on the queue instead of blocking the loop
        directly, and the watchdog must catch both signatures.
        """
        at = self._cfg.hang_at_step
        target_site = "prefetcher" if self._cfg.hang_in_prefetcher else "host"
        if at is None or self._hang_fired or step != at or site != target_site:
            return
        self._hang_fired = True
        self._notify(f"hang_{site}", step)
        duration = self._cfg.hang_duration_sec
        logger.warning(
            "fault injection: hanging the %s at step %d (%s)",
            "prefetch thread" if site == "prefetcher" else "host step loop",
            step,
            f"{duration:g}s" if duration is not None else "indefinitely",
        )
        deadline = None if duration is None else time.monotonic() + duration
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.05)

    def poison_host_losses(self, losses: Any, first_step: int) -> Any:
        """Scale the configured step's host-observed loss (one-shot).

        ``losses`` is the interval's loss vector; ``first_step`` is the
        optimizer step its first entry belongs to. Returns the (possibly
        copied and modified) vector.
        """
        at = self._cfg.spike_loss_at_step
        if at is None or self._spike_fired:
            return losses
        idx = at - first_step
        if 0 <= idx < len(losses):
            self._spike_fired = True
            self._notify("spike_loss", at)
            losses = losses.copy()
            losses[idx] = losses[idx] * self._cfg.spike_loss_scale
            logger.warning(
                "fault injection: scaled observed loss of step %d by x%g",
                at,
                self._cfg.spike_loss_scale,
            )
        return losses

    def maybe_corrupt_checkpoint(self, step: int, ckpt_mgr: Any) -> None:
        """Damage the newest checkpoint file after its save (one-shot).

        Drains the manager's async write first so the damage lands on the
        completed file, not a half-written tmp.
        """
        at = self._cfg.corrupt_checkpoint_at_step
        if at is None or self._corrupt_fired or step < at or ckpt_mgr is None:
            return
        ckpt_mgr.wait_pending()
        newest = ckpt_mgr.latest_checkpoint()
        if newest is None:
            return
        self._corrupt_fired = True
        self._notify("corrupt_checkpoint", step)
        data = newest.read_bytes()
        if self._cfg.corrupt_mode == "truncate":
            newest.write_bytes(data[: max(1, len(data) // 2)])
        else:  # garbage: flip a swath of bytes mid-file
            mid = len(data) // 2
            newest.write_bytes(
                data[:mid] + bytes(b ^ 0xFF for b in data[mid : mid + 64]) + data[mid + 64 :]
            )
        logger.warning(
            "fault injection: %s newest checkpoint %s after step-%d save",
            self._cfg.corrupt_mode + "d",
            newest.name,
            step,
        )

    # --------------------------------------------------------- flaky wiring

    def flaky(self, kind: str, fn: Callable[[], T]) -> Callable[[], T]:
        """Wrap ``fn`` so its first N calls raise InjectedFault, where N is
        the configured failure count for ``kind`` ("dataset_load" or
        "distributed_init"). With N == 0 the original callable is returned
        untouched."""
        budget = {
            "dataset_load": self._cfg.dataset_load_failures,
            "distributed_init": self._cfg.distributed_init_failures,
        }.get(kind, 0)
        if budget <= 0:
            return fn

        def wrapped() -> T:
            used = self._flaky_counts.get(kind, 0)
            if used < budget:
                self._flaky_counts[kind] = used + 1
                raise InjectedFault(
                    f"injected {kind} failure {used + 1}/{budget}"
                )
            return fn()

        return wrapped


__all__ = ["FaultPlan", "InjectedFault", "retry", "retry_rng"]
