"""The port's fleet (llmtrain_tpu_torch/fleet/ and ``fleet``) and
``federate_prometheus`` against the JAX package's, on the CPU.

Case for case with ``tests/test_fleet.py``:

* the policy (``candidate_world_sizes``, ``plan_allocations``,
  ``priority_order``, ``within_bounds``) on JAX's table and on
  hypothesis-drawn pools and demands, and the tenant state machine's legal
  and illegal transitions, equal JAX's;
* supervisor units: a segment's ranks pinned in their environments
  (JAX pins an XLA device count instead), the tenant configs JAX derives,
  the micro-batch rule, the bounds invariant, the escalation ladder on a
  group of TERM-ignoring ranks, the backoff draws, the report markdown,
  the federated scrape and the report's keys; the card check;
* ``federate_prometheus`` byte for byte JAX's on the same sources;
* the preempt fault, the partial-interval rule and the shared harness;
* the drills as gloo ranks: the 3-tenant storm held bitwise, a storm over
  ``gpt_fleet_smoke`` whose two-rank tenant is resized and held to
  ``resize_loss_rtol``, ``fleet --storm`` on the preset through the CLI, a
  twice-evicted tenant's resume count, a capacity-growth resize, the plain
  ``fleet`` round trip.
"""

from __future__ import annotations

import json
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_port_helpers import REPO_ROOT, port_env, run_cli

import llmtrain_tpu.fleet.policy as jax_policy
import llmtrain_tpu.fleet.tenant as jax_tenant
import llmtrain_tpu_torch.fleet.policy as policy
import llmtrain_tpu_torch.fleet.tenant as tenant
from llmtrain_tpu.config import RunConfig as JaxRunConfig
from llmtrain_tpu.telemetry.prometheus import federate_prometheus as jax_federate
from llmtrain_tpu_torch.config import RunConfig
from llmtrain_tpu_torch.telemetry.prometheus import federate_prometheus

PRESET = REPO_ROOT / "configs" / "presets" / "gpt_fleet_smoke.yaml"

# ------------------------------------------------------------------ policy

_TABLE = [
    (3, [("a", 1, (1, 2)), ("b", 0, (1,)), ("c", 0, (1,))], {"a": 1, "b": 1, "c": 1}, ()),
    (4, [("a", 1, (1, 2)), ("b", 0, (1, 2)), ("c", 0, (1,))], {"a": 2, "b": 1, "c": 1}, ()),
    (6, [("a", 1, (1, 2, 4)), ("b", 0, (1, 2))], {"a": 4, "b": 2}, ()),
    (2, [("a", 2, (1, 2)), ("b", 1, (1,)), ("c", 0, (1,))], {"a": 1, "b": 1, "c": 0}, ("c",)),
    (1, [("zeta", 0, (1,)), ("alpha", 0, (1,))], {"alpha": 1, "zeta": 0}, ("zeta",)),
    (0, [("a", 1, (1,)), ("b", 0, (1,))], {"a": 0, "b": 0}, ("a", "b")),
    (3, [("a", 1, (1, 4)), ("b", 0, (1,))], {"a": 1, "b": 1}, ()),
]


def _plans(pool, demands) -> tuple:
    plans = [mod.plan_allocations(pool, [mod.TenantDemand(*d) for d in demands])
             for mod in (policy, jax_policy)]
    return tuple((p.allocations, p.free_devices, p.suspended) for p in plans)


@pytest.mark.parametrize("pool,demands,expected,suspended", _TABLE)
def test_allocation_table_matches_jax(pool, demands, expected, suspended) -> None:
    ours, theirs = _plans(pool, demands)
    assert ours == theirs
    assert ours[0] == expected and ours[2] == suspended and sum(ours[0].values()) <= pool


@settings(max_examples=150, deadline=None)
@given(
    pool=st.integers(0, 12),
    tenants=st.lists(
        st.tuples(st.integers(-2, 3), st.integers(1, 8), st.integers(1, 4), st.integers(0, 4),
                  st.booleans()),
        min_size=1, max_size=5,
    ),
)
def test_plan_allocations_matches_jax_on_drawn_fleets(pool, tenants) -> None:
    demands = []
    for i, (prio, micro, lo, span, runnable) in enumerate(tenants):
        try:
            sizes = jax_policy.candidate_world_sizes(micro, lo, lo + span)
        except ValueError as exc:
            with pytest.raises(ValueError) as info:
                policy.candidate_world_sizes(micro, lo, lo + span)
            assert str(info.value) == str(exc)
            continue
        assert policy.candidate_world_sizes(micro, lo, lo + span) == sizes
        demands.append((f"t{i}", prio, sizes, runnable))
    ours, theirs = _plans(pool, demands)
    assert ours == theirs
    for name, prio, sizes, _ in demands:
        for mod in (policy, jax_policy):
            assert mod.within_bounds(ours[0][name], mod.TenantDemand(name, prio, sizes))
    order = [d.name for d in policy.priority_order([policy.TenantDemand(*d) for d in demands])]
    assert order == [d.name for d in jax_policy.priority_order(
        [jax_policy.TenantDemand(*d) for d in demands])]


@pytest.mark.parametrize("case", ["divisors", "infeasible", "non-runnable", "order",
                                  "within-bounds", "bad-demand"])
def test_policy_units_match_jax(case) -> None:
    def observe(mod):
        if case == "divisors":
            return [mod.candidate_world_sizes(*a) for a in ((8, 1, 4), (6, 2, 6), (2, 1, 2))]
        if case == "infeasible":
            with pytest.raises(ValueError, match="divides the") as info:
                mod.candidate_world_sizes(4, 3, 3)
            return str(info.value)
        if case == "non-runnable":
            return mod.plan_allocations(2, [mod.TenantDemand("done", 5, (1, 2), runnable=False),
                                            mod.TenantDemand("live", 0, (1, 2))]).allocations
        if case == "order":
            return [d.name for d in mod.priority_order(
                [mod.TenantDemand(n, 0, (1,)) for n in ("b", "a", "c")])]
        if case == "within-bounds":
            d = mod.TenantDemand("a", 0, (1, 2, 4))
            return [mod.within_bounds(n, d) for n in (0, 2, 3, 8)]
        errors = []
        for sizes in ((), (2, 1), (1, 1)):
            with pytest.raises(ValueError) as info:
                mod.TenantDemand("x", 0, sizes)
            errors.append(str(info.value))
        return errors

    assert observe(policy) == observe(jax_policy)


# ----------------------------------------------------------- state machine

_LEGAL = ("running", "preempting", "backoff", "running", "preempting", "suspended",
          "running", "completed")


@pytest.mark.parametrize(
    "path,bad",
    [((), "preempting"), ((), "completed"), (("running", "completed"), "running"),
     (("running", "preempting"), "running"), (("running", "backoff"), "preempting"),
     ((), "zombie")],
)
def test_illegal_transitions_raise_as_jax(path, bad) -> None:
    msgs = []
    for mod in (tenant, jax_tenant):
        sm = mod.TenantStateMachine("t")
        for to in path:
            sm.transition(to, "setup")
        with pytest.raises(mod.InvalidTransitionError) as info:
            sm.transition(bad, "illegal")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_state_table_and_happy_path_match_jax() -> None:
    assert tenant.TRANSITIONS == jax_tenant.TRANSITIONS
    assert tenant.ALL_STATES == jax_tenant.ALL_STATES
    assert tenant.TERMINAL_STATES == jax_tenant.TERMINAL_STATES
    histories = []
    for mod in (tenant, jax_tenant):
        sm = mod.TenantStateMachine("t")
        for to in _LEGAL:
            assert sm.can(to)
            sm.transition(to, "test")
        assert sm.state == "completed" and sm.terminal
        histories.append(sm.history)
    assert histories[0] == histories[1] and histories[0][0] == ("queued", "admitted")


# -------------------------------------------------------- supervisor units


def _raw(**fleet) -> dict:
    raw = yaml.safe_load(PRESET.read_text())
    raw.setdefault("fleet", {}).update(fleet)
    return raw


def _sup(tmp_path, raw=None, *, jax=False, **kw):
    """The port's (or JAX's) supervisor over the preset, from the raw dict
    as JAX's tests build it."""
    if jax:
        from llmtrain_tpu.fleet.supervisor import FleetSupervisor
        cls = JaxRunConfig
    else:
        from llmtrain_tpu_torch.fleet.supervisor import FleetSupervisor
        cls = RunConfig
    raw = raw or _raw()
    kw.setdefault("seed", 0)
    return FleetSupervisor(cls.model_validate(raw), raw, work_dir=tmp_path / "fleet", **kw)


def test_child_envs_pin_every_rank(tmp_path, monkeypatch) -> None:
    for key, value in (("RANK", "5"), ("WORLD_SIZE", "9"), ("LOCAL_RANK", "3"),
                       ("MASTER_PORT", "1"), ("JAX_PROCESS_ID", "4")):
        monkeypatch.setenv(key, value)
    sup = _sup(tmp_path)
    (one,) = sup._child_envs(1)
    assert not {"RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT", "JAX_PROCESS_ID"} & set(one)
    two = sup._child_envs(2)
    assert [(e["RANK"], e["WORLD_SIZE"], e["LOCAL_RANK"]) for e in two] == [
        ("0", "2", "0"), ("1", "2", "1")]
    assert two[0]["MASTER_ADDR"] == "127.0.0.1" and two[0]["MASTER_PORT"] == two[1]["MASTER_PORT"]
    assert two[0]["MASTER_PORT"] != "1" and "JAX_PROCESS_ID" not in two[1]
    assert str(REPO_ROOT) in two[1]["PYTHONPATH"].split(":")


@pytest.mark.parametrize("case", ["preset", "production", "drill"])
def test_tenant_base_configs_match_jax(tmp_path, case) -> None:
    raw = _raw()
    kw = {}
    if case != "preset":
        raw["trainer"].update(max_steps=120, save_every_steps=100, eval_every_steps=10)
        raw["mlflow"] = {"enabled": True}
        kw["drill"] = case == "drill"
    ours = _sup(tmp_path / "port", raw, **kw)
    theirs = _sup(tmp_path / "jax", raw, jax=True, **kw)
    for name, t in ours.tenants.items():
        base, jbase = t.base_config, theirs.tenants[name].base_config
        for b in (base, jbase):
            b["output"].pop("root_dir")
        assert base == jbase, name
        assert t.demand_sizes == theirs.tenants[name].demand_sizes
    base_b = ours.tenants["tenant-b"].base_config
    assert base_b["trainer"]["lr"] == 0.001 and base_b["model"]["extra"]["lora"]["rank"] == 4
    assert base_b["resilience"]["watchdog"]["enabled"] is True and "fleet" not in base_b
    a = ours.tenants["tenant-a"].base_config
    if case == "production":
        assert a["trainer"]["save_every_steps"] == 100 and a["mlflow"]["enabled"] is True
    if case == "drill":
        assert a["trainer"]["save_every_steps"] == 40 and a["trainer"]["eval_every_steps"] == 120
    assert a["telemetry"]["prometheus"] is False


@pytest.mark.parametrize("allocation", [1, 2])
def test_segment_config_scales_micro_batch_and_joins_ranks(tmp_path, allocation) -> None:
    sup = _sup(tmp_path)
    jsup = _sup(tmp_path / "jax", jax=True)
    t = sup.tenants["tenant-a"]
    seg = yaml.safe_load(sup._write_segment_cfg(t, 0, allocation, {"kill_at_step": 5}).read_text())
    jseg = yaml.safe_load(jsup._write_segment_cfg(jsup.tenants["tenant-a"], 0, allocation,
                                                  {"kill_at_step": 5}).read_text())
    assert seg["trainer"]["micro_batch_size"] * allocation == t.global_micro
    assert seg["distributed"]["enabled"] is (allocation > 1)
    for s in (seg, jseg):
        s.pop("distributed", None)
        s["output"].pop("root_dir")
    assert seg == jseg and seg["resilience"]["faults"] == {"kill_at_step": 5}


def test_launch_outside_bounds_is_an_invariant_error(tmp_path) -> None:
    from llmtrain_tpu_torch.fleet.supervisor import FleetInvariantError

    sup = _sup(tmp_path)
    with pytest.raises(FleetInvariantError, match="bounds"):
        sup._launch(sup.tenants["tenant-b"], 3)


_TERM_IGNORING = ("import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                  "print('up', flush=True); time.sleep(60)")


def test_escalation_ladder_sigkills_a_term_ignoring_group(tmp_path) -> None:
    """Rung 2 on a two-rank segment: both ranks trap SIGTERM; past the
    grace deadline the whole group is SIGKILLed."""
    from llmtrain_tpu_torch.fleet.supervisor import _RankGroup

    sup = _sup(tmp_path, _raw(preempt_grace_sec=0.3))
    t = sup.tenants["tenant-a"]
    procs = [subprocess.Popen([sys.executable, "-c", _TERM_IGNORING], stdout=subprocess.PIPE)
             for _ in range(2)]
    for p in procs:
        assert p.stdout.readline().strip() == b"up"
    t.proc = _RankGroup(procs)
    t.sm.transition("running", "test")
    sup._preempt(t, reason="test evict")
    assert t.sm.state == "preempting"
    deadline = time.monotonic() + 10.0
    while t.proc.poll() is None and time.monotonic() < deadline:
        sup._escalate_overdue(time.monotonic())
        time.sleep(0.05)
    assert t.proc.poll() == -signal.SIGKILL
    assert [p.returncode for p in procs] == [-signal.SIGKILL] * 2
    assert t.counts["escalations"] == 1


def test_rank_group_exit_code_is_the_first_failing_ranks(tmp_path) -> None:
    """A rank that fails takes the group down at once (the others would
    only wait in a collective): its code is the segment's; with no failure
    rank 0's."""
    from llmtrain_tpu_torch.fleet.supervisor import _RankGroup

    def group(*codes_and_sleeps):
        return _RankGroup([subprocess.Popen(
            [sys.executable, "-c", f"import time, sys; time.sleep({s}); sys.exit({c})"])
            for c, s in codes_and_sleeps])

    def settle(g):
        deadline = time.monotonic() + 20
        while g.poll() is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        return g

    g = settle(group((0, 0.0), (75, 0.2), (0, 30)))
    assert g.returncode == 75 and g.failed_rank == 1
    assert g.procs[2].returncode == -signal.SIGKILL
    g = settle(group((0, 0.1), (0, 0.0)))
    assert g.returncode == 0 and g.failed_rank is None


def test_backoff_draws_match_jax(tmp_path) -> None:
    ours, theirs = _sup(tmp_path / "a"), _sup(tmp_path / "b", jax=True)
    for name in ("tenant-a", "tenant-b"):
        t, jt = ours.tenants[name], theirs.tenants[name]
        draws = []
        for k in range(6):
            t.counts["crashes"] = jt.counts["crashes"] = k
            draws.append(ours._backoff_delay(t))
            assert draws[-1] == theirs._backoff_delay(jt)
        assert all(0.0 <= d <= ours._fleet.respawn_backoff_max_sec for d in draws)
    assert [ours._backoff_delay(ours.tenants["tenant-a"]) for _ in range(3)] != [
        ours._backoff_delay(ours.tenants["tenant-b"]) for _ in range(3)]


def test_render_fleet_report_md_matches_jax() -> None:
    from llmtrain_tpu.fleet.supervisor import render_fleet_report_md as jax_md
    from llmtrain_tpu_torch.fleet import render_fleet_report_md

    report = {
        "pool_devices": 2, "capacity_changes": 2, "wall_time_sec": 1.0, "seed": 0,
        "totals": {"completed": 1, "failed": 0, "evictions": 3, "escalations": 1,
                   "respawns": 3, "resizes": 1, "suspensions": 1, "goodput_frac": 0.5,
                   "goodput_wall_clock_sec": 4.0},
        "tenants": {"a": {"state": "completed", "priority": 1, "min_devices": 1,
                          "max_devices": 2, "segments": 4, "evictions": {"total": 3},
                          "respawns": 3, "resume_count": 2, "final_step": 12,
                          "final_loss": 3.25, "goodput": {"goodput_frac": 0.25}}},
    }
    md = render_fleet_report_md(report)
    assert md == jax_md(report)
    assert "| a | completed |" in md and "| 3 | 3 | 2 | 12 | 3.25 |" in md


def test_render_metrics_federates_tenant_textfiles_as_jax(tmp_path) -> None:
    ours, theirs = _sup(tmp_path / "a"), _sup(tmp_path / "b", jax=True)
    for sup in (ours, theirs):
        for name, loss, commits in (("tenant-a", 2.5, 3), ("tenant-b", 1.5, 4)):
            prom = sup.tenants[name].run_dir / "telemetry" / "metrics.prom"
            prom.parent.mkdir(parents=True, exist_ok=True)
            prom.write_text("# TYPE llmtrain_train_loss gauge\n"
                            f"llmtrain_train_loss {loss}\n"
                            "# TYPE llmtrain_ckpt_commits_total counter\n"
                            f"llmtrain_ckpt_commits_total {commits}\n", encoding="utf-8")
    text = ours._render_metrics()
    assert text == theirs._render_metrics()
    assert 'mode="fleet"' in text and 'llmtrain_train_loss{tenant="tenant-a"} 2.5' in text
    assert re.search(r"^llmtrain_ckpt_commits_total 7(\.0)?$", text, re.MULTILINE)
    (ours.tenants["tenant-a"].run_dir / "telemetry" / "metrics.prom").unlink()
    assert 'tenant="tenant-b"' in ours._render_metrics()


def test_report_keys_and_gauges_match_jax(tmp_path) -> None:
    """``fleet_report.json``/``.md`` and the gauges of a fleet that never
    launched: JAX's keys and text."""
    ours, theirs = _sup(tmp_path / "a"), _sup(tmp_path / "b", jax=True)
    reports = []
    for sup in (ours, theirs):
        sup._publish_metrics()
        report = sup.finalize()
        for v in report["tenants"].values():
            v["history"] = [list(h) for h in v["history"]]
        reports.append(report)
        assert json.loads((sup.work_dir / "fleet_report.json").read_text()) == report
    assert reports[0] == reports[1]
    assert (ours.work_dir / "fleet_report.md").read_text() == (
        theirs.work_dir / "fleet_report.md").read_text()
    assert dict(ours.metrics.latest()) == dict(theirs.metrics.latest())


def test_card_pool_needs_a_card_per_rank(tmp_path, capsys) -> None:
    """Off the CPU a tenant's ranks take a card each: wider than the cards
    present is a config error at construction (exit 2) naming the count,
    never a fall back to the CPU."""
    import torch

    raw = _raw()
    raw["run"]["device"] = "cuda"
    with pytest.raises(ValueError, match=rf"{torch.cuda.device_count()} card\(s\) are present"):
        _sup(tmp_path, raw)
    cfg = tmp_path / "card.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    from llmtrain_tpu_torch.cli import main

    assert run_cli(main, ["fleet", "--config", str(cfg), "--work-dir", str(tmp_path / "w")]) == 2
    err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]
    assert "tenant-a" in err and "card(s) are present" in err


# ------------------------------------------------------- federate_prometheus

_SOURCES = {
    "plain": {"a": "# TYPE llmtrain_x gauge\nllmtrain_x 1.5\n",
              "b": "# TYPE llmtrain_x gauge\nllmtrain_x 2\n"},
    "counters": {"a": "# TYPE llmtrain_c_total counter\nllmtrain_c_total 3\n",
                 "b": "# TYPE llmtrain_c_total counter\nllmtrain_c_total 4.5\n"
                      "llmtrain_c_total{reason=\"q\"} 1\n"},
    "labels-and-escapes": {'we"ird\\name': 'llmtrain_y{k="v # {x}",j="a\\"b"} 7\n'},
    "exemplars": {"a": "# TYPE llmtrain_h histogram\n"
                       'llmtrain_h_bucket{le="0.5"} 3 # {trace_id="abc"} 0.4 1700000000.0\n'
                       'llmtrain_h_bucket{le="+Inf"} 4 # {trace_id="d e"} 9\n'
                       "llmtrain_h_count 4\n"},
    "garbage": {"a": "not a sample\n# HELP x y\n{broken} 1\nllmtrain_ok 1\n\n  \n",
                "b": "llmtrain_ok NaN\n# TYPE llmtrain_ok counter\n"},
    "empty": {"a": "", "b": "# only comments\n"},
}


@pytest.mark.parametrize("case", sorted(_SOURCES))
def test_federate_prometheus_is_byte_equal_to_jax(case) -> None:
    ours = federate_prometheus(_SOURCES[case])
    assert ours == jax_federate(_SOURCES[case])
    if case == "counters":
        assert 'llmtrain_c_total{tenant="b",reason="q"} 1' in ours
        assert "\nllmtrain_c_total 8.5\n" in ours
    if case == "exemplars":
        assert 'llmtrain_h_bucket{tenant="a",le="0.5"} 3\n' in ours
    if case == "empty":
        assert ours == ""


# --------------------------------------------- faults, intervals, harness


def test_preempt_at_step_delivers_one_real_sigterm_as_jax() -> None:
    from llmtrain_tpu_torch.config.schemas import FaultInjectionConfig
    from llmtrain_tpu_torch.resilience.faults import FaultPlan

    hits: list[int] = []
    old = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        plan = FaultPlan(FaultInjectionConfig(preempt_at_step=3))
        fired: list[tuple[str, int]] = []
        plan.observer = lambda kind, step: fired.append((kind, step))
        for step in (2, 3, 3, 4):
            plan.maybe_sigterm(step)
        assert hits == [signal.SIGTERM] and fired == [("preempt", 3)]
    finally:
        signal.signal(signal.SIGTERM, old)
    with pytest.raises(Exception, match="exactly one"):
        FaultInjectionConfig(preempt_at_step=3, sigterm_at_step=4)


@pytest.mark.parametrize("resumed,log_every", [(None, 3), (6, 3), (7, 3), (8, 3), (4, 5),
                                               (0, 3)])
def test_partial_interval_step_matches_jax(resumed, log_every) -> None:
    from llmtrain_tpu.fleet.chaos import partial_interval_step as jax_rule
    from llmtrain_tpu_torch.fleet.chaos import partial_interval_step

    assert partial_interval_step(resumed, log_every) == jax_rule(resumed, log_every)


def test_storm_fault_plan_matches_jax(tmp_path) -> None:
    from llmtrain_tpu.fleet.chaos import _storm_fault_plan as jax_plan
    from llmtrain_tpu_torch.fleet.chaos import _storm_fault_plan

    raw = _raw()
    for seed in range(4):
        kw = dict(drill=True, seed=seed)
        assert _storm_fault_plan(_sup(tmp_path / f"p{seed}", raw, **kw), seed) == jax_plan(
            _sup(tmp_path / f"j{seed}", raw, jax=True, **kw), seed)


# ------------------------------------------------------------ the drills


def _storm3(tmp_path: Path) -> Path:
    """JAX's acceptance shape: 3 fixed-size tenants, all held bitwise."""
    raw = _raw()
    raw["fleet"] = {"pool_devices": 3, "preempt_grace_sec": 20.0, "tenants": [
        {"name": "alpha", "priority": 2, "min_devices": 1, "max_devices": 1},
        {"name": "bravo", "priority": 1, "min_devices": 1, "max_devices": 1,
         "overrides": {"trainer": {"lr": 0.001}}},
        {"name": "charlie", "priority": 0, "min_devices": 1, "max_devices": 1,
         "overrides": {"model": {"extra": {"lora": {"rank": 4, "alpha": 8}}}}},
    ]}
    path = tmp_path / "storm3.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


@pytest.fixture
def child_env(monkeypatch):
    """The supervisor's children inherit this process's environment: one
    CPU thread each, as every port test child."""
    for key, value in port_env().items():
        monkeypatch.setenv(key, value)


def test_three_tenant_storm_is_bitwise_recoverable(tmp_path, child_env) -> None:
    from llmtrain_tpu_torch.fleet.chaos import run_fleet_storm

    result = run_fleet_storm(_storm3(tmp_path), seed=1, work_dir=tmp_path / "storm",
                             timeout_sec=300.0)
    assert result["bitwise_match"] is True and len(result["tenants"]) == 3
    assert result["total_evictions"] >= 3 and result["capacity_changes"] >= 2
    assert result["total_suspensions"] >= 1 and result["mid_checkpoint_kill_tenant"]
    for name, r in result["tenants"].items():
        assert r["parity"] == "bitwise", name
        assert r["evictions"]["total"] >= 1 and r["resume_count"] >= 1, name
        assert r["trajectory_points_compared"] >= 1, name
    report = json.loads(Path(result["fleet_report_json"]).read_text())
    for name, v in report["tenants"].items():
        assert v["state"] == "completed" and all(a == 1 for a in v["allocations"]), name


def test_storm_resizes_a_two_rank_tenant(tmp_path, child_env) -> None:
    """The storm over ``gpt_fleet_smoke`` with a pool of 3: tenant-a starts
    on 2 gloo ranks, the capacity drop (held long enough for its
    relaunch) shrinks it to 1 and the restore grows it back; it is held to
    ``resize_loss_rtol``, tenant-b (fixed at 1 rank) bitwise."""
    from llmtrain_tpu_torch.fleet.chaos import run_fleet_storm

    cfg = tmp_path / "storm.yaml"
    cfg.write_text(yaml.safe_dump(_raw(pool_devices=3), sort_keys=False))
    result = run_fleet_storm(cfg, seed=1, max_steps=24, work_dir=tmp_path / "storm",
                             timeout_sec=240.0, step_delay_sec=0.2, capacity_drop_hold_sec=10.0)
    a, b = result["tenants"]["tenant-a"], result["tenants"]["tenant-b"]
    assert a["reference_allocation"] == 2 and a["parity"] == "loss_rtol<=0.02"
    assert b["reference_allocation"] == 1 and b["parity"] == "bitwise"
    assert result["bitwise_match"] is False and result["capacity_changes"] >= 2
    report = json.loads(Path(result["fleet_report_json"]).read_text())
    assert {1, 2} <= set(report["tenants"]["tenant-a"]["allocations"])
    assert all(v["state"] == "completed" for v in report["tenants"].values())
    seg = tmp_path / "storm" / "segments"
    assert list(seg.glob("tenant-a_seg000.r1.out")), "the two-rank segment's rank 1"


def test_storm_cli_round_trip(tmp_path) -> None:
    """``fleet --storm`` over ``gpt_fleet_smoke`` as it ships: exit 0, the
    JSON result with JAX's keys, every tenant completed, each held bitwise
    exactly when it kept its reference allocation."""
    proc = subprocess.run(
        [sys.executable, "-m", "llmtrain_tpu_torch", "fleet", "--config", str(PRESET),
         "--storm", "--seed", "1", "--work-dir", str(tmp_path / "storm"), "--timeout-sec",
         "240", "--json"],
        capture_output=True, text=True, env=port_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(result) == sorted([
        "seed", "tenants", "pool_devices", "capacity_drop_to", "capacity_changes",
        "mid_checkpoint_kill_tenant", "total_evictions", "total_respawns",
        "total_suspensions", "fleet_goodput_frac", "bitwise_match", "fleet_report_json",
        "work_dir", "wall_time_sec"])
    report = json.loads(Path(result["fleet_report_json"]).read_text())
    for name, r in result["tenants"].items():
        view = report["tenants"][name]
        assert view["state"] == "completed" and r["evictions"]["total"] >= 1, name
        kept = all(n == r["reference_allocation"] for n in view["allocations"])
        assert r["parity"] == ("bitwise" if kept else "loss_rtol<=0.02"), (name, view)
    assert result["mid_checkpoint_kill_tenant"] and result["capacity_changes"] >= 2


def _solo_supervisor(tmp_path, raw, work, seed, delay):
    from llmtrain_tpu_torch.fleet.supervisor import FleetSupervisor

    return FleetSupervisor(RunConfig.model_validate(raw), raw, work_dir=tmp_path / work,
                           seed=seed, extra_tenant_overrides={
                               "trainer": {"extra": {"step_delay_sec": delay}}})


def test_twice_evicted_tenant_accumulates_resume_count(tmp_path, child_env) -> None:
    raw = _raw()
    raw["fleet"] = {"pool_devices": 1, "preempt_grace_sec": 20.0, "tenants": [
        {"name": "solo", "priority": 0, "min_devices": 1, "max_devices": 1}]}
    sup = _solo_supervisor(tmp_path, raw, "fair", 3, 0.2)
    state = {"evicted": 0}

    def controller(s) -> None:
        # Each eviction waits for a commit of the running segment's own
        # (past its resume point): its SIGTERM handler is up by then, so
        # the eviction is graceful, not a signal at interpreter start.
        t = s.tenants["solo"]
        if (state["evicted"] < 2 and t.sm.state == "running" and t.segments
                and s.newest_commit("solo") > t.segments[-1]["expected_resume"]
                and s.request_eviction("solo", "graceful")):
            state["evicted"] += 1

    report = sup.run(timeout_sec=240.0, on_tick=controller)
    view = report["tenants"]["solo"]
    assert view["state"] == "completed" and state["evicted"] == 2
    assert view["evictions"]["graceful"] == 2 and view["resume_count"] == 2
    run_report = json.loads((sup.work_dir / "runs" / "solo" / "report.json").read_text())
    assert run_report["resilience"]["resume_count"] == 2


def test_capacity_growth_triggers_elastic_resize(tmp_path, child_env) -> None:
    raw = _raw()
    raw["trainer"]["max_steps"] = 18
    raw["fleet"] = {"pool_devices": 2, "preempt_grace_sec": 20.0, "tenants": [
        {"name": "grower", "priority": 1, "min_devices": 1, "max_devices": 2},
        {"name": "shortlived", "priority": 0, "min_devices": 1, "max_devices": 1,
         "overrides": {"trainer": {"max_steps": 6}}}]}
    sup = _solo_supervisor(tmp_path, raw, "resize", 5, 0.25)
    report = sup.run(timeout_sec=240.0)
    grower = report["tenants"]["grower"]
    assert grower["state"] == "completed" and grower["resizes"] >= 1
    assert 2 in grower["allocations"] and grower["final_step"] == 18
    assert report["tenants"]["shortlived"]["state"] == "completed"


def test_fleet_cli_round_trip(tmp_path) -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "llmtrain_tpu_torch", "fleet", "--config", str(PRESET),
         "--work-dir", str(tmp_path / "cli"), "--max-steps", "6", "--json"],
        capture_output=True, text=True, env=port_env(), timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["totals"]["completed"] == 2
    work = tmp_path / "cli"
    assert (work / "fleet_report.json").is_file() and (work / "fleet_report.md").is_file()
    prom = (work / "fleet_metrics.prom").read_text()
    assert "llmtrain_fleet_pool_devices" in prom and "llmtrain_fleet_tenants_completed" in prom
    assert 'tenant="tenant-a"' in prom


def test_cli_rejects_fleetless_config_as_jax(capsys) -> None:
    from llmtrain_tpu.cli import main as jax_main
    from llmtrain_tpu_torch.cli import main

    argv = ["fleet", "--config", str(PRESET.parent / "gpt_smoke.yaml")]
    assert run_cli(main, argv) == run_cli(jax_main, argv) == 2
