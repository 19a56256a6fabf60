"""Exponential-backoff retry (port of the first part of
``llmtrain_tpu/resilience/faults.py``: :func:`retry` and :func:`retry_rng`).

The trainer's dataset setup and the CLI's rendezvous run through
:func:`retry`. The fault-injection plan (``FaultPlan`` and its ``flaky``
wrapper) comes with ROADMAP.md queue A: resilience; until then the two
call sites pass the function itself.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

from ..utils.logging import get_logger

logger = get_logger()

T = TypeVar("T")


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
    """Run ``fn`` with full-jitter exponential backoff: attempt ``k`` sleeps
    ``uniform(0, min(max_delay, base·2^(k-1)))`` (``jitter=False``: the cap
    itself). A seeded ``rng`` (:func:`retry_rng`) makes the delays
    reproducible per rank and different across ranks. The last failure
    re-raises the original exception unchanged."""
    if jitter and rng is None:
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
                description, attempt, attempts, exc, delay,
            )
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retry_rng(seed: int, process_index: int = 0) -> random.Random:
    """Seeded backoff-jitter RNG, deterministic per (seed, rank)."""
    return random.Random(f"llmtrain-retry:{seed}:{process_index}")


__all__ = ["retry", "retry_rng"]
