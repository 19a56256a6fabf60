"""The port's overload control against the JAX package's.

The same scripted arrivals, on one fake clock, go through
``llmtrain_tpu.serving.overload.OverloadController`` and the port's copy:
admission verdicts (reason and Retry-After), the weighted dequeue order,
the learned queue wait, brownout transitions, shedding, the token clamp
and ``stats()`` must be equal after every event. The client gate and the
retry budget are driven the same way. Pure Python on both sides.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import pytest

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.serving import overload as jax_overload
from llmtrain_tpu_torch.serving import overload as port_overload


class _Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def _req(name: str, priority: str = "interactive", deadline_ms: float | None = None) -> Any:
    return SimpleNamespace(name=name, priority=priority, deadline_ms=deadline_ms,
                           submitted_t=0.0, queue_depth_at_submit=0)


def _calm_then_burst() -> list[tuple]:
    """Calm arrivals served promptly, a burst that fills the queue and
    pushes the predicted wait past the brownout watermark, then calm."""
    ev: list[tuple] = []
    for i in range(4):
        ev += [("submit", f"c{i}", "interactive", None), ("tick",), ("advance", 0.02),
               ("pop",), ("tick",)]
    for i in range(12):
        ev += [("submit", f"b{i}", "batch" if i % 3 == 0 else "interactive", 400.0),
               ("advance", 0.005)]
    for _ in range(6):
        ev += [("advance", 0.3), ("pop",), ("tick",), ("sweep",)]
    for _ in range(6):
        ev += [("advance", 0.05), ("pop",), ("tick",), ("sweep",)]
    for i in range(12):  # calm again: prompt service teaches the estimator low waits
        ev += [("submit", f"t{i}", "interactive", None), ("advance", 0.002), ("pop",),
               ("tick",)]
    return ev + [("stats",)]


def _rate_limited() -> list[tuple]:
    ev: list[tuple] = []
    for i in range(6):
        ev += [("submit", f"i{i}", "batch", None), ("advance", 0.1)]
    return ev + [("advance", 2.0), ("submit", "late", "batch", None), ("stats",)]


def _deadlines() -> list[tuple]:
    ev: list[tuple] = [("observe", 200.0, 0), ("observe", 300.0, 1)]
    for i, d in enumerate((50.0, 5000.0, None, 10.0, 1000.0)):
        ev += [("submit", f"d{i}", "interactive", d)]
    return ev + [("advance", 1.5), ("tick",), ("tick",), ("tick",), ("sweep",), ("pop",),
                 ("pop",), ("stats",)]


SCENARIOS = {
    "calm-burst-calm": (dict(queue_cap=8, brownout_high_ms=300.0, brownout_low_ms=60.0,
                             brownout_enter_ticks=2, brownout_exit_ticks=2),
                        _calm_then_burst()),
    "class-token-bucket": (dict(class_rate_rps={"batch": 2.0}, class_burst={"batch": 2}),
                           _rate_limited()),
    "deadline-unmeetable-and-shed": (dict(queue_cap=16, default_deadline_ms=250.0,
                                          brownout_high_ms=100.0, brownout_low_ms=50.0,
                                          brownout_enter_ticks=1),
                                     _deadlines()),
}


def _drive(module: Any, kw: dict, events: list[tuple]) -> list[Any]:
    clock = _Clock()
    ctl = module.OverloadController(clock=clock, **kw)
    out: list[Any] = []
    for ev in events:
        kind, *args = ev
        if kind == "submit":
            name, priority, deadline = args
            req = _req(name, priority, deadline)
            if req.deadline_ms is None and ctl.default_deadline_ms:
                req.deadline_ms = ctl.default_deadline_ms
            req.submitted_t = clock.now
            depth = len(ctl.queue)
            req.queue_depth_at_submit = depth
            verdict = ctl.admission_check(req, depth)
            if verdict is None:
                ctl.queue.append(req)
            else:
                ctl.note_rejection(verdict[0])
            out.append((kind, name, verdict, req.admission_predicted_wait_ms))
        elif kind == "advance":
            clock.now += args[0]
        elif kind == "pop":
            req = ctl.queue.popleft() if ctl.queue else None
            if req is not None:
                ctl.observe_queue_wait((clock.now - req.submitted_t) * 1e3,
                                       req.queue_depth_at_submit)
            out.append((kind, None if req is None else req.name))
        elif kind == "observe":
            ctl.observe_queue_wait(*args)
        elif kind == "tick":
            out.append((kind, ctl.tick(len(ctl.queue)), ctl.in_brownout, ctl.shedding_active,
                        ctl.clamp_new_tokens(64), ctl.predicted_wait_ms(len(ctl.queue))))
        elif kind == "sweep":
            shed = ctl.queue.sweep(lambda r: ctl.past_deadline(r, clock.now)) \
                if ctl.shedding_active else []
            for r in shed:
                ctl.note_rejection(port_overload.REASON_DEADLINE_EXCEEDED, shed=True)
            out.append((kind, [r.name for r in shed]))
        elif kind == "stats":
            out.append((kind, ctl.stats()))
        else:
            raise AssertionError(kind)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decisions_match_jax(name: str) -> None:
    kw, events = SCENARIOS[name]
    theirs = _drive(jax_overload, kw, events)
    ours = _drive(port_overload, kw, events)
    assert ours == theirs
    assert any(o[0] == "submit" and o[2] is not None for o in ours), "no rejection exercised"


def test_burst_scenario_enters_and_leaves_brownout() -> None:
    """The calm-burst-calm script does what it is meant to cover."""
    kw, events = SCENARIOS["calm-burst-calm"]
    ours = _drive(port_overload, kw, events)
    transitions = [o[1] for o in ours if o[0] == "tick" and o[1] is not None]
    assert transitions == ["entered", "exited"]
    assert any(o[0] == "sweep" and o[1] for o in _drive(
        port_overload, *SCENARIOS["deadline-unmeetable-and-shed"]))


def test_from_config_matches_jax() -> None:
    from llmtrain_tpu.config.schemas import OverloadConfig as JaxOverloadConfig
    from llmtrain_tpu_torch.config.schemas import OverloadConfig

    raw = dict(enabled=True, queue_cap=3, class_rate_rps={"batch": 1.5}, brownout_high_ms=80.0,
               brownout_low_ms=20.0)
    ours = port_overload.OverloadController.from_config(OverloadConfig(**raw))
    theirs = jax_overload.OverloadController.from_config(JaxOverloadConfig(**raw))
    assert ours.stats() == theirs.stats()


def _gate_and_budget(module: Any) -> list[Any]:
    clock = _Clock()
    gate = module.ClientRateGate(2.0, 2.0, max_clients=2, clock=clock)
    budget = module.RetryBudget(3, 1.0, clock=clock)
    out = []
    for step in range(12):
        client = ("a", "b", "c")[step % 3]
        out.append(("gate", client, gate.check(client)))
        out.append(("budget", budget.try_spend(), budget.remaining()))
        clock.now += 0.15
    return out


def test_client_gate_and_retry_budget_match_jax() -> None:
    assert _gate_and_budget(port_overload) == _gate_and_budget(jax_overload)
