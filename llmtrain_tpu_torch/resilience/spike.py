"""Loss-spike detection with checkpoint auto-rollback support (port of
``llmtrain_tpu/resilience/spike.py``, pure Python; the port keeps its own
copy).

A loss spike that the non-finite guard cannot catch — still finite, but an
order of magnitude above trend — usually means the optimizer state was
poisoned a few steps back (bad batch × high LR, bf16 overflow that rounded
to a huge finite value). Waiting it out costs wall-clock and often never
recovers; the production move (TorchTitan, MegaScale) is to restore the
last good checkpoint and step PAST the offending data window.

:class:`LossSpikeDetector` keeps a bias-corrected rolling EWMA of the train
loss and flags an observation that exceeds ``factor ×`` the trend once at
least ``min_history`` steps have been observed. The spike itself is NOT
folded into the EWMA (one poisoned value would inflate the trend and mask a
second spike). The detector's state round-trips through the checkpoint
payload (``state()``/``load_state()``) so a preempted-and-resumed run keeps
its armed trend instead of re-warming from scratch.

The trainer consumes this at log-interval boundaries — the same place it
already syncs losses to host — so detection adds zero extra device syncs.
"""

from __future__ import annotations

import math


class LossSpikeDetector:
    def __init__(
        self,
        *,
        factor: float,
        beta: float = 0.9,
        min_history: int = 20,
    ) -> None:
        if factor <= 1.0:
            raise ValueError("spike factor must be > 1")
        if not 0.0 < beta < 1.0:
            raise ValueError("ewma beta must be in (0, 1)")
        self._factor = factor
        self._beta = beta
        self._min_history = max(1, min_history)
        self._acc = 0.0  # biased EWMA accumulator
        self._count = 0  # finite observations folded in

    @property
    def trend(self) -> float | None:
        """Bias-corrected EWMA of the observed losses (None before any)."""
        if self._count == 0:
            return None
        return self._acc / (1.0 - self._beta**self._count)

    @property
    def armed(self) -> bool:
        return self._count >= self._min_history

    def observe(self, loss: float) -> bool:
        """Feed one train-loss value; True means "this is a spike".

        Non-finite losses return False and leave the trend untouched — the
        non-finite guard owns that failure mode. A flagged spike is also
        kept out of the trend so consecutive spikes keep firing.
        """
        if not math.isfinite(loss):
            return False
        trend = self.trend
        if self.armed and trend is not None and loss > self._factor * trend:
            return True
        self._acc = self._beta * self._acc + (1.0 - self._beta) * loss
        self._count += 1
        return False

    # ------------------------------------------------------- checkpoint I/O

    def state(self) -> dict[str, float]:
        return {"spike_ewma_acc": float(self._acc), "spike_obs": int(self._count)}

    def load_state(self, state: dict) -> None:
        self._acc = float(state.get("spike_ewma_acc", 0.0))
        self._count = int(state.get("spike_obs", 0))


class RollbackBudgetExceededError(RuntimeError):
    """Raised when loss spikes keep recurring past ``max_rollbacks`` —
    repeated rollback means the run diverges deterministically and a human
    (or sweep controller) must change the config, not the scheduler."""


__all__ = ["LossSpikeDetector", "RollbackBudgetExceededError"]
