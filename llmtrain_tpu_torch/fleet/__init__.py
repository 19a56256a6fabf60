"""Multi-tenant fleet control plane (the port of ``llmtrain_tpu/fleet/``):
many jobs, shared device capacity, preemption-aware scheduling
(``llmtrain fleet``, docs/robustness.md "Fleet: many tenants, shared
capacity").

* ``policy`` — deterministic pure scheduling policy (quota / priority /
  shrink-before-suspend over feasible elastic world sizes).
* ``tenant`` — the validated tenant lifecycle state machine.
* ``supervisor`` — the control loop: real train subprocesses (one per
  rank) with ``--auto-resume``, the SIGTERM→deadline→SIGKILL escalation ladder,
  seeded full-jitter respawn backoff, elastic resizes, fleet health
  (``llmtrain_fleet_*`` gauges, fleet_report.json/.md).
* ``chaos`` — the seeded preemption-storm acceptance drill: every
  tenant's trajectory must end bitwise-equal to its uninterrupted
  reference.
"""

from .policy import (
    AllocationPlan,
    TenantDemand,
    candidate_world_sizes,
    plan_allocations,
    priority_order,
    within_bounds,
)
from .supervisor import FleetInvariantError, FleetSupervisor, render_fleet_report_md
from .tenant import InvalidTransitionError, TenantStateMachine

__all__ = [
    "AllocationPlan",
    "FleetInvariantError",
    "FleetSupervisor",
    "InvalidTransitionError",
    "TenantDemand",
    "TenantStateMachine",
    "candidate_world_sizes",
    "plan_allocations",
    "priority_order",
    "render_fleet_report_md",
    "within_bounds",
]
