"""Background batch prefetcher: overlap host assembly + H2D with compute
(port of ``llmtrain_tpu/data/prefetch.py``).

:class:`BatchPrefetcher` moves the per-step numpy gathers and the
host→device copy onto a daemon thread that runs the deterministic index
math *ahead* of the consumer and keeps a bounded queue of assembled
batches, so the loop's ``get(step)`` normally returns immediately.

* **Determinism** — batches are a pure function of ``(seed, step)``; the
  prefetcher only changes *when* they are assembled, never *what* is
  assembled.
* **Shutdown** — an exception can break the loop while the queue is full
  and the producer is blocked in ``put``. :meth:`close` sets the stop
  event, drains the queue so the producer unblocks, and joins with a
  bounded timeout — a producer wedged inside a hung fetch is abandoned
  (daemon thread), never waited on.
* **Error transparency** — an assembly exception is re-raised in the
  consumer at the next ``get``, once the batches assembled before it are
  consumed, so the run fails at the step the synchronous path would.
* **Telemetry** — with a ``timeline`` the producer records a
  ``prefetch_assemble`` span per batch, so the trace shows host assembly
  overlapping device compute; :attr:`queue_depth` feeds the
  ``data/prefetch_queue_depth`` gauge.

The JAX prefetcher's rollback ``reseek`` and fault hooks serve features
the port has not ported (ROADMAP.md queue A: resilience) and are left out.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

from ..utils.logging import get_logger

logger = get_logger()

# How long a blocked producer put / consumer get sleeps between checks of
# the stop state. Purely an internal responsiveness bound.
_POLL_SEC = 0.05


class PrefetcherClosedError(RuntimeError):
    """``get`` was called on a prefetcher that has been closed."""


class BatchPrefetcher:
    """Bounded look-ahead queue of assembled batches, keyed by step.

    ``assemble(step)`` must be a deterministic function of the step.
    ``depth`` bounds how many assembled batches may exist ahead of the
    consumer, which bounds the extra device memory the pipeline holds.
    """

    def __init__(
        self,
        assemble: Callable[[int], Any],
        *,
        depth: int,
        start_step: int,
        name: str = "batch-prefetch",
        timeline: Any | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1 (0 = don't construct one)")
        self._assemble = assemble
        self._timeline = timeline
        self._queue: queue.Queue[tuple[int, Any]] = queue.Queue(maxsize=depth)
        self._next_step = start_step
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            step = self._next_step
            self._next_step += 1
            try:
                if self._timeline is not None:
                    with self._timeline.span("prefetch_assemble", cat="data", step=step):
                        batch = self._assemble(step)
                else:
                    batch = self._assemble(step)
            except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
                self._error = exc
                return
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=_POLL_SEC)
                    break
                except queue.Full:
                    continue

    def get(self, step: int) -> Any:
        """The assembled batch for optimizer step ``step`` (blocking); the
        caller drives steps in order. A producer error is re-raised once
        the queue is empty."""
        while True:
            if self._stop.is_set():
                raise PrefetcherClosedError("prefetcher is closed")
            try:
                got_step, batch = self._queue.get(timeout=_POLL_SEC)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                continue
            if got_step != step:
                # Unreachable with in-order consumption; fail loudly rather
                # than train on the wrong data.
                raise RuntimeError(
                    f"prefetcher out of sync: queued step {got_step}, consumer wants {step}"
                )
            return batch

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and release anything it is blocked on; a
        producer wedged inside a hung assembly is abandoned (daemon)."""
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
    def closed(self) -> bool:
        return self._stop.is_set()

    @property
    def queue_depth(self) -> int:
        """Batches currently queued ahead of the consumer (approximate;
        a telemetry gauge, never used for control flow)."""
        return self._queue.qsize()

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return


__all__ = ["BatchPrefetcher", "PrefetcherClosedError"]
