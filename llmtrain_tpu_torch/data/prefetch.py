"""Background batch prefetcher: overlap host assembly + H2D with compute
(port of ``llmtrain_tpu/data/prefetch.py``).

:class:`BatchPrefetcher` moves the per-step numpy gathers and the
host→device copy onto a daemon thread that runs the deterministic index
math *ahead* of the consumer and keeps a bounded queue of assembled
batches, so the loop's ``get(step)`` normally returns immediately.

* **Determinism** — batches are a pure function of ``(seed, step,
  data_offset)``; the prefetcher only changes *when* they are assembled,
  never *what* is assembled, so loss trajectories are bitwise identical
  with prefetch on vs. off, across resume and rollback.
* **Rollback** — a loss-spike rollback mutates the trainer's
  ``_data_offset`` and replays a window. Every queued batch assembled
  under the old offset is invalid. :meth:`reseek` bumps a generation
  counter, drains the queue, and repositions the producer; the consumer
  discards any entry whose generation tag is stale (the consumer-side
  check is authoritative — the producer-side check merely avoids wasted
  work). :attr:`generation` counts the reseeks.
* **Shutdown** — SIGTERM preemption or an exception can break the loop
  while the queue is full and the producer is blocked in ``put``.
  :meth:`close` sets the stop event, drains the queue so the producer
  unblocks, and joins with a bounded timeout — a producer wedged inside
  a hung dataset fetch is abandoned (daemon thread), never waited on.
* **Error transparency** — an assembly exception is re-raised in the
  consumer at the next ``get``, preserving the original exception object
  so callers' error handling (CLI exit codes, test asserts) sees the
  real cause.
* **Faults and telemetry** — ``before_assemble(step)`` runs before each
  assembly (the ``prefetcher`` site of the fault plan's hang); with a
  ``timeline`` the producer records a ``prefetch_assemble`` span per
  batch; :attr:`queue_depth` feeds the ``data/prefetch_queue_depth``
  gauge.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

from ..utils.logging import get_logger

logger = get_logger()

# How long a blocked producer put / consumer get sleeps between checks of
# the stop/generation state. Purely an internal responsiveness bound.
_POLL_SEC = 0.05


class PrefetcherClosedError(RuntimeError):
    """``get`` was called on a prefetcher that has been closed."""


class BatchPrefetcher:
    """Bounded look-ahead queue of assembled batches, keyed by step.

    ``assemble(step)`` must be a deterministic function of the step (plus
    any state — like the trainer's data offset — that is only mutated
    under the :meth:`reseek` protocol). ``depth`` bounds how many
    assembled batches may exist ahead of the consumer, which bounds the
    extra device memory the pipeline holds (depth batches queued plus one
    in flight in the producer).
    """

    def __init__(
        self,
        assemble: Callable[[int], Any],
        *,
        depth: int,
        start_step: int,
        name: str = "batch-prefetch",
        before_assemble: Callable[[int], None] | None = None,
        timeline: Any | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1 (0 = don't construct one)")
        self._assemble = assemble
        self._before_assemble = before_assemble
        # Telemetry hook (telemetry/timeline.py): the producer records a
        # prefetch_assemble span per batch so the trace shows host
        # assembly overlapping device compute — the whole point of the
        # async pipeline, now visible instead of inferred.
        self._timeline = timeline
        self._name = name
        self._queue: queue.Queue[tuple[int, int, Any]] = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._generation = 0
        self._next_step = start_step
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producer

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                gen = self._generation
                step = self._next_step
                self._next_step += 1
            try:
                if self._before_assemble is not None:
                    # Fault-injection hook (resilience.faults.hang_in_
                    # prefetcher): a REAL block here strands the consumer
                    # on the queue, which is exactly the stall the hang
                    # watchdog must detect from outside.
                    self._before_assemble(step)
                if self._timeline is not None:
                    with self._timeline.span(
                        "prefetch_assemble", cat="data", step=step
                    ):
                        batch = self._assemble(step)
                else:
                    batch = self._assemble(step)
            except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
                with self._lock:
                    self._error = exc
                return
            # Hand over, unless a reseek invalidated this batch mid-flight
            # or the consumer is gone. The generation re-check before each
            # put attempt keeps a blocked producer from stuffing a stale
            # batch into the queue a reseek just drained.
            while not self._stop.is_set():
                with self._lock:
                    if self._generation != gen:
                        break  # stale: drop it, loop back for the new position
                try:
                    self._queue.put((gen, step, batch), timeout=_POLL_SEC)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------- consumer

    def get(self, step: int) -> Any:
        """The assembled batch for optimizer step ``step`` (blocking).

        The caller drives steps in order; after a rollback it must call
        :meth:`reseek` before resuming. Stale-generation entries are
        discarded silently. A producer error is re-raised here — but only
        once the queue is empty, so batches assembled before the failure
        are still consumed and the run fails at the same step the
        synchronous path would have failed at.
        """
        while True:
            # close() is only ever called by the consumer thread itself, so
            # this check cannot race with normal consumption.
            if self._stop.is_set():
                raise PrefetcherClosedError("prefetcher is closed")
            try:
                gen, got_step, batch = self._queue.get(timeout=_POLL_SEC)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                continue
            with self._lock:
                if gen != self._generation:
                    continue  # assembled before the last reseek
            if got_step != step:
                # With in-order consumption and the reseek protocol this is
                # unreachable; fail loudly rather than training on the
                # wrong data if a future caller breaks the protocol.
                raise RuntimeError(
                    f"prefetcher out of sync: queued step {got_step}, "
                    f"consumer wants {step}"
                )
            return batch

    def reseek(self, step: int) -> None:
        """Invalidate everything queued or in flight and restart the
        producer's cursor at ``step`` — the rollback hook: the trainer
        mutates ``_data_offset`` first, then reseeks, so every batch the
        replay consumes is assembled under the post-rollback offset.

        The drain runs INSIDE the lock: the producer can only pick up the
        new (generation, step) cursor under this same lock, so nothing
        assembled for the new generation can reach the queue before the
        drain finishes — draining after releasing would race a fast
        producer and eat its first valid replay batches. At most one
        in-flight OLD-generation item can land mid-drain (a put does not
        hold the lock); the consumer's generation check discards it.

        A producer that died on a PRE-reseek assembly error is revived
        with the error cleared: that failure belongs to the invalidated
        generation (the synchronous path would re-assemble the replay
        window under the new offset and may well succeed), so surfacing
        it after a rollback would abort a run the escape-hatch path
        completes.
        """
        with self._lock:
            self._generation += 1
            self._next_step = step
            self._drain()
            revive = self._error is not None and not self._stop.is_set()
            if revive:
                self._error = None
        if revive:
            # The producer thread returns right after setting _error, so
            # a fresh thread (not a resurrection race) picks up the new
            # generation's cursor.
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True
            )
            self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and release anything it is blocked on.

        Bounded: a producer wedged inside a hung assembly (dead storage,
        injected hang) is abandoned to die with the process — the exit
        path must never deadlock on the pipeline it is tearing down."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning(
                "prefetch thread still blocked in assembly after %.1fs; "
                "abandoning it (daemon)",
                timeout,
            )

    @property
    def generation(self) -> int:
        """Reseeks so far (the trainer's rollbacks while it ran)."""
        return self._generation

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    @property
    def queue_depth(self) -> int:
        """Batches currently queued ahead of the consumer (approximate —
        qsize is advisory under concurrency; published as a telemetry
        gauge, never used for control flow)."""
        return self._queue.qsize()

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return


__all__ = ["BatchPrefetcher", "PrefetcherClosedError"]
