"""Tenant lifecycle state machine (the port's copy of
``llmtrain_tpu/fleet/tenant.py``).

Every tenant of the fleet supervisor moves through an explicit, validated
state machine — the supervisor can only take transitions this table
allows, so a control-flow bug (respawning a completed tenant, suspending
one that already failed) surfaces as a loud
:class:`InvalidTransitionError` instead of a silently corrupted fleet.

States::

    queued ──► running ──► completed
                 │  ▲            ▲
                 ▼  │            │
            preempting ──────────┘ (finished during the grace window)
               │   │
               ▼   ▼
          suspended backoff ──► running
               │      ▲
               └──────┘ (capacity returned)

* ``queued`` — admitted to the fleet, never launched yet.
* ``running`` — a live group of train subprocesses (one a rank) owns the
  tenant's allocation.
* ``preempting`` — SIGTERM sent (resize/suspend/evict); the escalation
  ladder's deadline clock is running toward SIGKILL.
* ``backoff`` — exited and will respawn after its seeded full-jitter
  delay (crash, retryable exit, eviction with capacity still granted).
* ``suspended`` — exited with no capacity granted; waits for the pool,
  not for a timer. "Suspend rather than crash" is this state.
* ``completed`` / ``failed`` — terminal.
"""

from __future__ import annotations

QUEUED = "queued"
RUNNING = "running"
PREEMPTING = "preempting"
BACKOFF = "backoff"
SUSPENDED = "suspended"
COMPLETED = "completed"
FAILED = "failed"

ALL_STATES = (QUEUED, RUNNING, PREEMPTING, BACKOFF, SUSPENDED, COMPLETED, FAILED)
TERMINAL_STATES = (COMPLETED, FAILED)

TRANSITIONS: dict[str, frozenset[str]] = {
    QUEUED: frozenset({RUNNING, FAILED}),
    RUNNING: frozenset({PREEMPTING, BACKOFF, SUSPENDED, COMPLETED, FAILED}),
    PREEMPTING: frozenset({BACKOFF, SUSPENDED, COMPLETED, FAILED}),
    BACKOFF: frozenset({RUNNING, SUSPENDED, FAILED}),
    SUSPENDED: frozenset({RUNNING, BACKOFF, FAILED}),
    COMPLETED: frozenset(),
    FAILED: frozenset(),
}


class InvalidTransitionError(RuntimeError):
    """The supervisor attempted a lifecycle move the table forbids — a
    control-plane bug, never a tenant failure."""


class TenantStateMachine:
    """Current state + audited history of one tenant's lifecycle."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._state = QUEUED
        # [(state, reason)] starting with the initial state; the fleet
        # report embeds this so every eviction/suspension is explainable.
        self.history: list[tuple[str, str]] = [(QUEUED, "admitted")]

    @property
    def state(self) -> str:
        return self._state

    @property
    def terminal(self) -> bool:
        return self._state in TERMINAL_STATES

    def can(self, to: str) -> bool:
        return to in TRANSITIONS[self._state]

    def transition(self, to: str, reason: str = "") -> None:
        if to not in TRANSITIONS:
            raise InvalidTransitionError(
                f"tenant {self.name!r}: unknown state {to!r}"
            )
        if to not in TRANSITIONS[self._state]:
            raise InvalidTransitionError(
                f"tenant {self.name!r}: illegal transition "
                f"{self._state} -> {to} ({reason or 'no reason given'})"
            )
        self._state = to
        self.history.append((to, reason))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TenantStateMachine({self.name!r}, state={self._state!r})"


__all__ = [
    "ALL_STATES",
    "BACKOFF",
    "COMPLETED",
    "FAILED",
    "InvalidTransitionError",
    "PREEMPTING",
    "QUEUED",
    "RUNNING",
    "SUSPENDED",
    "TERMINAL_STATES",
    "TRANSITIONS",
    "TenantStateMachine",
]
