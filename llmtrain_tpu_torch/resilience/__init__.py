"""Fault-tolerance layer (port of ``llmtrain_tpu/resilience/``): so far the
exit-code taxonomy and the backoff retry. The non-finite guard lives in
the trainer; spike rollback, fault injection, the watchdog, elastic
resume and the chaos harness wait for ROADMAP.md queue A: resilience."""

from .exit_codes import (
    EXIT_CONFIG_ERROR,
    EXIT_HANG_DETECTED,
    EXIT_OK,
    EXIT_RETRYABLE_INFRA,
    EXIT_TRAIN_FAILURE,
    RETRYABLE_EXIT_CODES,
    RetryableInfraError,
    exit_code_for_exception,
    is_retryable,
)
from .faults import retry, retry_rng

__all__ = [
    "EXIT_CONFIG_ERROR",
    "EXIT_HANG_DETECTED",
    "EXIT_OK",
    "EXIT_RETRYABLE_INFRA",
    "EXIT_TRAIN_FAILURE",
    "RETRYABLE_EXIT_CODES",
    "RetryableInfraError",
    "exit_code_for_exception",
    "is_retryable",
    "retry",
    "retry_rng",
]
