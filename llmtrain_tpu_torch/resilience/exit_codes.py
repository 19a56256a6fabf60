"""Process exit-code taxonomy: clean / fatal / retryable-infra (port of
``llmtrain_tpu/resilience/exit_codes.py``; that module imports no JAX, but
the port keeps its own copy).

==== ======================= ==============================================
code class                   meaning
==== ======================= ==============================================
0    clean                   run completed (incl. preemption save + exit)
1    fatal (training)        deterministic failure — divergence, bad data,
                             bug; retrying reproduces it
2    fatal (config)          invalid config/CLI usage, an incompatible
                             resume topology, or a feature not yet ported
75   retryable infra         EX_TEMPFAIL — transient environment failure
                             (rendezvous, dataset fetch, storage blip);
                             the orchestrator should restart the pod
76   retryable hang          the hang watchdog hard-exited a stalled run
==== ======================= ==============================================

The k8s job spec (``k8s/job-tpu-v5e.yaml``) retries only 75, 76 and 137,
so a transient fault must exit 75 for the job to survive it.
"""

from __future__ import annotations

EXIT_OK = 0
EXIT_TRAIN_FAILURE = 1
EXIT_CONFIG_ERROR = 2
# sysexits.h EX_TEMPFAIL: "temporary failure, user is invited to retry".
EXIT_RETRYABLE_INFRA = 75
# Watchdog-detected stalls, counted apart from other infra failures; still
# retryable.
EXIT_HANG_DETECTED = 76

RETRYABLE_EXIT_CODES = frozenset({EXIT_RETRYABLE_INFRA, EXIT_HANG_DETECTED})
FATAL_EXIT_CODES = frozenset({EXIT_TRAIN_FAILURE, EXIT_CONFIG_ERROR})


def is_retryable(code: int) -> bool:
    """True when the orchestrator should restart the pod for this code."""
    return code in RETRYABLE_EXIT_CODES


class RetryableInfraError(RuntimeError):
    """Raise (or wrap a cause with) this to mark a failure as transient
    infrastructure trouble: the CLI maps it to :data:`EXIT_RETRYABLE_INFRA`."""


# Transient by nature even when nobody wrapped them. OSError at large is
# NOT here: a missing file or a permission error is deterministic.
_RETRYABLE_TYPES: tuple[type[BaseException], ...] = (
    RetryableInfraError,
    TimeoutError,
    ConnectionError,
    InterruptedError,
)


def _exception_chain(exc: BaseException):
    """``exc`` and its cause/context chain, cycle-safe.

    Explicit ``__cause__`` always counts; implicit ``__context__`` only
    when not suppressed: ``raise X from None`` severs the chain, so a
    deterministic error raised while handling a transient one does not
    inherit "retryable" from it.
    """
    seen: set[int] = set()
    node: BaseException | None = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        yield node
        nxt = node.__cause__
        if nxt is None and not node.__suppress_context__:
            nxt = node.__context__
        node = nxt


def exit_code_for_exception(exc: BaseException) -> int:
    """Map an exception escaping a CLI handler onto the taxonomy, walking
    the cause/context chain as JAX's function does.

    The port's own convention comes first: a ``NotImplementedError``
    anywhere in the chain is a refusal of a feature not yet ported, a
    config error (2). Then JAX's three walks: an incompatible topology
    (2), a deterministic divergence or an exhausted rollback budget (1),
    a transient cause or an injected infra fault (75). Unknown exceptions
    are fatal (1).

    A ``MeshPlanError`` (autotune/plan.py: a mesh layout that cannot
    run) is a config error (2), as in JAX.
    """
    # Local imports, as JAX's: the constants load without the classes.
    from ..autotune.plan import MeshPlanError
    from .elastic import TopologyMismatchError
    from .faults import InjectedFault
    from .guard import NonFiniteLossError
    from .spike import RollbackBudgetExceededError

    chain = list(_exception_chain(exc))
    if any(isinstance(node, NotImplementedError) for node in chain):
        return EXIT_CONFIG_ERROR
    if any(isinstance(node, (TopologyMismatchError, MeshPlanError)) for node in chain):
        return EXIT_CONFIG_ERROR
    # Deterministic divergence beats any wrapped transient error.
    if any(isinstance(node, (NonFiniteLossError, RollbackBudgetExceededError))
           for node in chain):
        return EXIT_TRAIN_FAILURE
    if any(isinstance(node, (*_RETRYABLE_TYPES, InjectedFault)) for node in chain):
        return EXIT_RETRYABLE_INFRA
    return EXIT_TRAIN_FAILURE


__all__ = [
    "EXIT_CONFIG_ERROR",
    "EXIT_HANG_DETECTED",
    "EXIT_OK",
    "EXIT_RETRYABLE_INFRA",
    "EXIT_TRAIN_FAILURE",
    "FATAL_EXIT_CODES",
    "RETRYABLE_EXIT_CODES",
    "RetryableInfraError",
    "exit_code_for_exception",
    "is_retryable",
]
