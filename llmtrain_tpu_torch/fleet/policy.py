"""Deterministic preemption-aware scheduling policy over shared capacity (the
port's copy of ``llmtrain_tpu/fleet/policy.py``; a device is a rank).

Pure functions only — no clocks, no processes, no randomness — so every
quota/priority/shrink-before-suspend decision is table-testable (tier-1)
and two supervisors looking at the same fleet state always compute the
same plan. The supervisor (fleet/supervisor.py) owns the messy parts
(signals, subprocesses, backoff); this module owns WHO gets HOW MANY
devices.

The policy (MinT's scheduling argument, PAPERS.md: preemption is a
scheduling decision, not a disaster):

1. **Admit by priority.** Runnable tenants sorted by (-priority, name)
   each receive their smallest feasible world size while capacity lasts;
   a tenant whose minimum no longer fits is SUSPENDED (allocation 0) —
   degraded, never crashed. Shrinking a low-priority tenant to its
   minimum to admit a high-priority one falls out of the same pass: the
   high-priority tenant is granted first, so the low one only keeps what
   is left.
2. **Grow round-robin.** Remaining capacity is handed out one feasibility
   step at a time in priority order, so a spare device goes to the
   highest-priority tenant below its quota, and nobody exceeds
   ``max_devices``.

Feasibility: a tenant's world size must divide its global micro-batch —
that is exactly the elastic-resume contract (``micro_batch_size × dp``
constant, resilience/elastic.py), so every resize the policy can emit is
a resize the trainer can resume through with a preserved trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class TenantDemand:
    """What the scheduler needs to know about one tenant."""

    name: str
    priority: int
    # Ascending feasible world sizes (candidate_world_sizes); the first
    # entry is the tenant's minimum footprint, the last its quota.
    candidate_sizes: tuple[int, ...]
    runnable: bool = True

    def __post_init__(self) -> None:
        if not self.candidate_sizes:
            raise ValueError(f"tenant {self.name!r} has no feasible world size")
        if list(self.candidate_sizes) != sorted(set(self.candidate_sizes)):
            raise ValueError(
                f"tenant {self.name!r}: candidate_sizes must be strictly "
                f"ascending, got {self.candidate_sizes}"
            )


@dataclass
class AllocationPlan:
    """The policy's output: device grant per tenant (0 = suspended)."""

    allocations: dict[str, int] = field(default_factory=dict)
    free_devices: int = 0
    suspended: tuple[str, ...] = ()


def candidate_world_sizes(
    global_micro_batch: int, min_devices: int, max_devices: int
) -> tuple[int, ...]:
    """Feasible world sizes for a tenant: every device count in
    [min_devices, max_devices] that divides the tenant's global
    micro-batch — the allocations elastic resume can re-shard across with
    an unchanged trajectory. Raises when the window contains none (a
    config error: the tenant could never be scheduled legally)."""
    sizes = tuple(
        d
        for d in range(min_devices, max_devices + 1)
        if global_micro_batch % d == 0
    )
    if not sizes:
        raise ValueError(
            f"no device count in [{min_devices}, {max_devices}] divides the "
            f"global micro-batch {global_micro_batch}; elastic resume "
            "requires micro_batch_size x world size to stay constant — "
            "adjust trainer.micro_batch_size or the tenant's device bounds"
        )
    return sizes


def priority_order(demands: list[TenantDemand]) -> list[TenantDemand]:
    """Deterministic scheduling order: priority desc, then name — ties
    never depend on dict/iteration order."""
    return sorted(demands, key=lambda d: (-d.priority, d.name))


def plan_allocations(pool_devices: int, demands: list[TenantDemand]) -> AllocationPlan:
    """Compute the target world size for every tenant (see module doc).

    Non-runnable tenants (completed/failed) are carried in the result with
    allocation 0 so callers can reconcile over one dict.
    """
    if pool_devices < 0:
        raise ValueError(f"pool_devices must be >= 0, got {pool_devices}")
    alloc = {d.name: 0 for d in demands}
    order = priority_order([d for d in demands if d.runnable])
    free = pool_devices

    # Pass 1: minimum footprints by priority; what does not fit suspends.
    for d in order:
        need = d.candidate_sizes[0]
        if need <= free:
            alloc[d.name] = need
            free -= need

    # Pass 2: round-robin growth, one feasibility step per turn, priority
    # first — a single spare device goes to the most important tenant
    # below quota, and repeated rounds spread the rest fairly.
    grew = True
    while grew and free > 0:
        grew = False
        for d in order:
            cur = alloc[d.name]
            if cur == 0:
                continue  # suspended tenants do not grow past admission
            bigger = next((c for c in d.candidate_sizes if c > cur), None)
            if bigger is not None and bigger - cur <= free:
                free -= bigger - cur
                alloc[d.name] = bigger
                grew = True

    suspended = tuple(
        d.name for d in order if d.runnable and alloc[d.name] == 0
    )
    return AllocationPlan(allocations=alloc, free_devices=free, suspended=suspended)


def within_bounds(allocation: int, demand: TenantDemand) -> bool:
    """Bounds invariant the storm drill asserts on every launch: a tenant
    runs with one of its feasible sizes, or not at all."""
    return allocation == 0 or allocation in demand.candidate_sizes


__all__ = [
    "AllocationPlan",
    "TenantDemand",
    "candidate_world_sizes",
    "plan_allocations",
    "priority_order",
    "within_bounds",
]
