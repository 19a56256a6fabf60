"""Fault-tolerance layer (port of ``llmtrain_tpu/resilience/``): the
non-finite guard on the device, loss-spike rollback, fault injection,
full-jitter retry, the hang watchdog with its heartbeat and straggler
telemetry, the exit-code taxonomy, elastic topology-change validation
(``elastic.py``), and the seeded chaos-recovery harness (``chaos.py``,
``llmtrain_tpu_torch chaos``), with JAX's ``__all__``.

Wired through config (``resilience:`` section), the train step, the
trainer loop, the checkpoint manager (asynchronous writes, the atomic
commit, ``before_step`` selection for the rollback) and the CLI's exit
codes, with every recovery path exercised end to end by the
config-driven fault-injection plan.
"""

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
from .elastic import (
    TopologyMismatchError,
    classify_topology_change,
    describe_topology,
    resume_batch_index,
)
from .faults import FaultPlan, InjectedFault, retry, retry_rng
from .guard import NonFiniteLossError, tree_all_finite
from .spike import LossSpikeDetector, RollbackBudgetExceededError
from .watchdog import (
    HangWatchdog,
    ProgressBeacon,
    StragglerTracker,
    heartbeat_age_seconds,
)

__all__ = [
    "EXIT_CONFIG_ERROR",
    "EXIT_HANG_DETECTED",
    "EXIT_OK",
    "EXIT_RETRYABLE_INFRA",
    "EXIT_TRAIN_FAILURE",
    "FaultPlan",
    "HangWatchdog",
    "InjectedFault",
    "LossSpikeDetector",
    "NonFiniteLossError",
    "ProgressBeacon",
    "RETRYABLE_EXIT_CODES",
    "RetryableInfraError",
    "RollbackBudgetExceededError",
    "StragglerTracker",
    "TopologyMismatchError",
    "classify_topology_change",
    "describe_topology",
    "exit_code_for_exception",
    "heartbeat_age_seconds",
    "is_retryable",
    "resume_batch_index",
    "retry",
    "retry_rng",
    "tree_all_finite",
]
