"""SLO-aware overload control for the serving tier (the port's copy of
``llmtrain_tpu/serving/overload.py``, pure Python; docs/serving.md
"Overload and SLOs").

The continuous-batching scheduler's admission queue used to be an
unbounded FIFO: a traffic burst grew queue wait without limit until
waiters timed out and the abandoned-request shedder cleaned up AFTER the
device had been promised work it could never deliver on time. MinT
(PAPERS.md) argues SLO percentiles must be first-class scheduling
inputs; this module is that control layer — saturation degrades
predictably instead of collapsing:

* **Bounded, deadline-aware admission** — a queue cap plus an EWMA
  predicted-queue-wait estimator: a request whose deadline cannot
  plausibly be met is rejected AT SUBMIT (fast, with a retry-after
  hint) instead of queueing to die.
* **Priority classes** — a weighted-round-robin multi-class queue
  (``interactive``/``batch`` by default) with optional per-class token
  buckets; batch never starves interactive, and interactive never
  starves batch (every WRR cycle visits every class).
* **Brownout with hysteresis** — sustained pressure (predicted wait
  over the high watermark for N consecutive ticks) enters a degraded
  mode that clamps ``max_new_tokens`` and disables speculative
  drafting to protect TTFT; it exits only after the pressure signal
  holds below a LOWER watermark, so the mode cannot flap.
* **Retry budget** — a fixed-window cap the router spends on failover
  retries, so an overloaded fleet is never DDoS'd by its own front
  tier.

Every decision lands as ``llmtrain_serve_rejected_total{reason}`` /
``llmtrain_serve_brownout`` / predicted-wait gauges plus timeline
instants (scheduler.py publishes them; this module only counts).

Threading: the scheduler calls admission/tick/observe methods under its
own lock or from its single scheduler thread; the token buckets and the
HTTP-boundary client gate carry their own locks because handler threads
hit them directly.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Iterable

# Rejection taxonomy — the {reason} label on
# llmtrain_serve_rejected_total and the ``reason`` field of 429 bodies.
REASON_QUEUE_FULL = "queue_full"
REASON_RATE_LIMITED = "rate_limited"
REASON_DEADLINE_UNMEETABLE = "deadline_unmeetable"
REASON_DEADLINE_EXCEEDED = "deadline_exceeded"
REASON_RETRY_BUDGET = "retry_budget_exhausted"

REJECT_REASONS = (
    REASON_QUEUE_FULL,
    REASON_RATE_LIMITED,
    REASON_DEADLINE_UNMEETABLE,
    REASON_DEADLINE_EXCEEDED,
    REASON_RETRY_BUDGET,
)


def rejected_counter(reason: str) -> str:
    """Registry counter key for one rejection reason. The embedded label
    survives Prometheus rendering (telemetry/prometheus.py splits it
    back out), so every reason is one labeled series of
    ``llmtrain_serve_rejected_total``."""
    return f'serve/rejected{{reason="{reason}"}}'


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec, ``burst`` capacity.

    Injectable ``clock`` for deterministic tests; thread-safe (the HTTP
    per-client gate shares buckets across handler threads).
    """

    def __init__(
        self,
        rate: float,
        burst: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"token bucket burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate
        )
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if they are)."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                return 0.0
            return (n - self._tokens) / self.rate


class EwmaWaitEstimator:
    """EWMA of the observed queue-wait cost PER QUEUE POSITION.

    Each admission reports ``(actual wait, queue depth at submit)``; the
    per-position cost ``wait / (depth + 1)`` feeds an EWMA, and the
    predicted wait for a NEW arrival is ``per_position * (depth + 1)``.
    ``prior_ms`` seeds the estimate so the very first requests are not
    admitted blind with a zero prediction.
    """

    def __init__(self, beta: float = 0.8, prior_ms: float = 50.0) -> None:
        if not 0.0 < beta < 1.0:
            raise ValueError(f"ewma beta must be in (0, 1), got {beta}")
        self.beta = float(beta)
        self._per_slot_ms = float(prior_ms)
        self.samples = 0

    def observe(self, wait_ms: float, depth_at_submit: int) -> None:
        per_slot = max(0.0, float(wait_ms)) / max(1, int(depth_at_submit) + 1)
        self._per_slot_ms = (
            self.beta * self._per_slot_ms + (1.0 - self.beta) * per_slot
        )
        self.samples += 1

    @property
    def per_slot_ms(self) -> float:
        return self._per_slot_ms

    def predicted_wait_ms(self, depth: int) -> float:
        return self._per_slot_ms * (max(0, int(depth)) + 1)


class WeightedClassQueue:
    """Multi-class admission queue with weighted-round-robin dequeue.

    Drop-in for the scheduler's ``deque`` surface (``append`` /
    ``appendleft`` / ``popleft`` / ``len`` / truthiness). ``popleft``
    walks a weight-expanded WRR schedule, so with
    ``{"interactive": 4, "batch": 1}`` a backlogged queue drains 4
    interactive per batch — and EVERY cycle visits every class, so no
    class starves. ``appendleft`` pushes back to the front of the
    request's own class (the pool-full retry path).
    """

    def __init__(self, weights: dict[str, int], default_class: str) -> None:
        if not weights:
            raise ValueError("weighted queue needs at least one class")
        if default_class not in weights:
            raise ValueError(
                f"default class {default_class!r} is not one of "
                f"{sorted(weights)}"
            )
        for name, w in weights.items():
            if int(w) < 1:
                raise ValueError(f"class {name!r} weight must be >= 1")
        self.default_class = default_class
        self._queues: dict[str, deque] = {name: deque() for name in weights}
        self._schedule = [
            name for name, w in weights.items() for _ in range(int(w))
        ]
        self._cursor = 0

    def class_of(self, req: Any) -> str:
        cls = getattr(req, "priority", None)
        return cls if cls in self._queues else self.default_class

    def append(self, req: Any) -> None:
        self._queues[self.class_of(req)].append(req)

    def appendleft(self, req: Any) -> None:
        self._queues[self.class_of(req)].appendleft(req)

    def popleft(self) -> Any:
        n = len(self._schedule)
        for off in range(n):
            name = self._schedule[(self._cursor + off) % n]
            if self._queues[name]:
                self._cursor = (self._cursor + off + 1) % n
                return self._queues[name].popleft()
        raise IndexError("pop from an empty WeightedClassQueue")

    def sweep(self, predicate: Callable[[Any], bool]) -> list[Any]:
        """Remove and return every queued request matching ``predicate``
        (deadline shedding) without disturbing relative order."""
        out: list[Any] = []
        for q in self._queues.values():
            kept = deque()
            for req in q:
                if predicate(req):
                    out.append(req)
                else:
                    kept.append(req)
            q.clear()
            q.extend(kept)
        return out

    def depths(self) -> dict[str, int]:
        return {name: len(q) for name, q in self._queues.items()}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self) -> Iterable[Any]:
        for q in self._queues.values():
            yield from q


class Brownout:
    """Hysteresis state machine over a scalar pressure signal (ms).

    Enters after ``enter_ticks`` CONSECUTIVE ticks at/above ``high_ms``;
    exits after ``exit_ticks`` consecutive ticks BELOW ``low_ms``. The
    gap between the watermarks is what keeps the mode from flapping at
    the threshold.
    """

    def __init__(
        self,
        *,
        high_ms: float,
        low_ms: float,
        enter_ticks: int = 3,
        exit_ticks: int = 3,
    ) -> None:
        if low_ms >= high_ms:
            raise ValueError(
                f"brownout low watermark ({low_ms}) must be below the high "
                f"watermark ({high_ms})"
            )
        self.high_ms = float(high_ms)
        self.low_ms = float(low_ms)
        self.enter_ticks = int(enter_ticks)
        self.exit_ticks = int(exit_ticks)
        self.active = False
        self.entries = 0
        self.exits = 0
        self._over = 0
        self._under = 0

    def tick(self, pressure_ms: float) -> str | None:
        """Feed one pressure sample; returns "entered"/"exited" on a
        transition, else None."""
        if not self.active:
            self._over = self._over + 1 if pressure_ms >= self.high_ms else 0
            if self._over >= self.enter_ticks:
                self.active = True
                self.entries += 1
                self._over = 0
                self._under = 0
                return "entered"
            return None
        self._under = self._under + 1 if pressure_ms < self.low_ms else 0
        if self._under >= self.exit_ticks:
            self.active = False
            self.exits += 1
            self._over = 0
            self._under = 0
            return "exited"
        return None


class RetryBudget:
    """Fixed-window cap on router failover retries.

    ``budget`` spends per ``window_sec`` window; the window resets
    wholesale (fixed, not sliding — cheap and good enough to bound the
    retry amplification factor). Thread-safe: failovers run on the
    router's per-request threads.
    """

    def __init__(
        self,
        budget: int,
        window_sec: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if budget < 0:
            raise ValueError(f"retry budget must be >= 0, got {budget}")
        if window_sec <= 0:
            raise ValueError(f"retry window must be > 0, got {window_sec}")
        self.budget = int(budget)
        self.window_sec = float(window_sec)
        self._clock = clock
        self._window_start = clock()
        self._spent = 0
        self._lock = threading.Lock()

    def _roll(self, now: float) -> None:
        if now - self._window_start >= self.window_sec:
            self._window_start = now
            self._spent = 0

    def try_spend(self) -> bool:
        with self._lock:
            self._roll(self._clock())
            if self._spent < self.budget:
                self._spent += 1
                return True
            return False

    def remaining(self) -> int:
        with self._lock:
            self._roll(self._clock())
            return self.budget - self._spent


class ClientRateGate:
    """Per-client token buckets at the HTTP boundary, keyed by the
    ``X-Client-Id`` header (clients without one share the anonymous
    bucket). LRU-capped so a client-id cardinality attack cannot grow
    the map without bound."""

    def __init__(
        self,
        rate_rps: float,
        burst: int,
        *,
        max_clients: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rate_rps = float(rate_rps)
        self.burst = int(burst)
        self.max_clients = int(max_clients)
        self._clock = clock
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._lock = threading.Lock()

    def check(self, client_id: str) -> float | None:
        """None = admit; else the retry-after hint (seconds)."""
        with self._lock:
            bucket = self._buckets.get(client_id)
            if bucket is None:
                bucket = TokenBucket(
                    self.rate_rps, self.burst, clock=self._clock
                )
                self._buckets[client_id] = bucket
            self._buckets.move_to_end(client_id)
            while len(self._buckets) > self.max_clients:
                self._buckets.popitem(last=False)
        if bucket.try_acquire():
            return None
        return bucket.retry_after()


class OverloadController:
    """The scheduler-side overload policy: admission verdicts, queue-wait
    learning, deadline shedding, and the brownout state machine.

    One controller per scheduler. Its ``queue`` (a WeightedClassQueue)
    replaces the scheduler's FIFO deque; the scheduler calls
    ``admission_check`` under its submit lock, ``observe_queue_wait`` at
    each admission, and ``tick`` once per step.
    """

    def __init__(
        self,
        *,
        queue_cap: int = 64,
        default_deadline_ms: float = 0.0,
        ewma_beta: float = 0.8,
        prior_wait_ms: float = 50.0,
        class_weights: dict[str, int] | None = None,
        default_class: str = "interactive",
        class_rate_rps: dict[str, float] | None = None,
        class_burst: dict[str, int] | None = None,
        brownout_high_ms: float = 500.0,
        brownout_low_ms: float = 100.0,
        brownout_enter_ticks: int = 3,
        brownout_exit_ticks: int = 3,
        brownout_max_new_tokens: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        weights = dict(class_weights or {"interactive": 4, "batch": 1})
        self.queue_cap = int(queue_cap)
        self.default_deadline_ms = float(default_deadline_ms)
        self.class_weights = weights
        self.default_class = default_class
        self.brownout_max_new_tokens = int(brownout_max_new_tokens)
        self._clock = clock
        self.estimator = EwmaWaitEstimator(ewma_beta, prior_wait_ms)
        self.queue = WeightedClassQueue(weights, default_class)
        self.brownout = Brownout(
            high_ms=brownout_high_ms,
            low_ms=brownout_low_ms,
            enter_ticks=brownout_enter_ticks,
            exit_ticks=brownout_exit_ticks,
        )
        self.buckets: dict[str, TokenBucket] = {}
        for name, rate in (class_rate_rps or {}).items():
            if name not in weights:
                raise ValueError(
                    f"class_rate_rps names unknown class {name!r} "
                    f"(classes: {sorted(weights)})"
                )
            burst = (class_burst or {}).get(name, max(1, int(rate)))
            self.buckets[name] = TokenBucket(rate, burst, clock=clock)
        # Counters (scheduler thread + submit threads): one lock.
        self._lock = threading.Lock()
        self.rejected: dict[str, int] = {}
        self.shed = 0
        self._last_pressure_ms = 0.0

    @classmethod
    def from_config(cls, cfg: Any, **overrides: Any) -> "OverloadController":
        """Build from a ``serving.overload`` config section
        (config/schemas.py OverloadConfig — duck-typed, so tests can
        pass a namespace)."""
        kwargs = dict(
            queue_cap=cfg.queue_cap,
            default_deadline_ms=cfg.default_deadline_ms,
            ewma_beta=cfg.ewma_beta,
            prior_wait_ms=cfg.prior_wait_ms,
            class_weights=dict(cfg.classes),
            default_class=cfg.default_class,
            class_rate_rps=dict(cfg.class_rate_rps),
            class_burst=dict(cfg.class_burst),
            brownout_high_ms=cfg.brownout_high_ms,
            brownout_low_ms=cfg.brownout_low_ms,
            brownout_enter_ticks=cfg.brownout_enter_ticks,
            brownout_exit_ticks=cfg.brownout_exit_ticks,
            brownout_max_new_tokens=cfg.brownout_max_new_tokens,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    # ---------------------------------------------------------- admission

    def admission_check(
        self, req: Any, depth: int
    ) -> tuple[str, float] | None:
        """Admission verdict for one submitted request: None admits,
        otherwise ``(reason, retry_after_sec)`` rejects. Checked in
        cheapness order — the queue cap costs a comparison, the bucket a
        refill, the deadline a multiply. The predicted wait the verdict
        was decided on is stamped onto the request (best-effort) so a
        rejection's distributed trace shows WHY it was turned away."""
        try:
            req.admission_predicted_wait_ms = round(
                self.estimator.predicted_wait_ms(depth), 3
            )
        except Exception:  # noqa: BLE001 — annotation only, never reject on it
            pass
        if depth >= self.queue_cap:
            return (
                REASON_QUEUE_FULL,
                max(0.001, self.estimator.per_slot_ms * self.queue_cap / 1e3),
            )
        bucket = self.buckets.get(self.queue.class_of(req))
        if bucket is not None and not bucket.try_acquire():
            return (REASON_RATE_LIMITED, max(0.001, bucket.retry_after()))
        deadline_ms = getattr(req, "deadline_ms", None)
        if deadline_ms:
            predicted = self.estimator.predicted_wait_ms(depth)
            if predicted > float(deadline_ms):
                return (
                    REASON_DEADLINE_UNMEETABLE,
                    max(0.001, (predicted - float(deadline_ms)) / 1e3),
                )
        return None

    def observe_queue_wait(self, wait_ms: float, depth_at_submit: int) -> None:
        self.estimator.observe(wait_ms, depth_at_submit)

    def predicted_wait_ms(self, depth: int) -> float:
        return self.estimator.predicted_wait_ms(depth)

    def note_rejection(self, reason: str, *, shed: bool = False) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
            if shed:
                self.shed += 1

    # ----------------------------------------------------------- brownout

    def tick(self, depth: int) -> str | None:
        """One scheduler-step pressure sample; returns the brownout
        transition ("entered"/"exited") when one fires."""
        self._last_pressure_ms = self.estimator.predicted_wait_ms(depth)
        return self.brownout.tick(self._last_pressure_ms)

    @property
    def in_brownout(self) -> bool:
        return self.brownout.active

    @property
    def shedding_active(self) -> bool:
        """Eager past-deadline shedding runs under SUSTAINED overload
        (brownout, or pressure at/above the high watermark right now) —
        in calm seas a late request still gets served."""
        return (
            self.brownout.active
            or self._last_pressure_ms >= self.brownout.high_ms
        )

    def clamp_new_tokens(self, max_new_tokens: int) -> int:
        if self.in_brownout:
            return min(int(max_new_tokens), self.brownout_max_new_tokens)
        return int(max_new_tokens)

    def past_deadline(self, req: Any, now: float | None = None) -> bool:
        deadline_ms = getattr(req, "deadline_ms", None)
        if not deadline_ms:
            return False
        now = self._clock() if now is None else now
        return (now - req.submitted_t) * 1e3 > float(deadline_ms)

    # ---------------------------------------------------------- telemetry

    def stats(self) -> dict[str, Any]:
        with self._lock:
            rejected = dict(self.rejected)
            shed = self.shed
        return {
            "queue_cap": self.queue_cap,
            "queue_depths": self.queue.depths(),
            "predicted_wait_ms": round(self._last_pressure_ms, 3),
            "per_slot_wait_ms": round(self.estimator.per_slot_ms, 3),
            "in_brownout": self.in_brownout,
            "brownout_entries": self.brownout.entries,
            "brownout_exits": self.brownout.exits,
            "rejected": rejected,
            "rejected_total": sum(rejected.values()),
            "shed": shed,
        }


__all__ = [
    "Brownout",
    "ClientRateGate",
    "EwmaWaitEstimator",
    "OverloadController",
    "REASON_DEADLINE_EXCEEDED",
    "REASON_DEADLINE_UNMEETABLE",
    "REASON_QUEUE_FULL",
    "REASON_RATE_LIMITED",
    "REASON_RETRY_BUDGET",
    "REJECT_REASONS",
    "RetryBudget",
    "TokenBucket",
    "WeightedClassQueue",
    "rejected_counter",
]
