"""The port's autotune (``llmtrain_tpu_torch/autotune/``) against JAX's
(``llmtrain_tpu/autotune/``) on the CPU.

* ``predict_hbm_bytes`` and ``analytic_candidate_cost`` equal JAX's over a
  grid of plans (meshes, remat, tier ladders, ZeRO, the three losses);
  ``MeshPlan``'s key, overrides and topology are JAX's.
* ``enumerate_candidates`` gives JAX's candidates in JAX's seeded order;
  ``prune_candidates`` keeps JAX's survivors and prunes with JAX's
  reasons, the resume constraint included.
* The count on ``meta`` tensors (``lowered_candidate_cost``) reports
  ``source: "lowered"`` for the presets, its flops within
  ``MFU_RECONCILE_BAND`` of JAX's XLA-lowered count.
* ``plan``: JAX's payload keys and values, exit 0 feasible, 2 for an
  infeasible mesh or a prediction over the memory limit.
* The activation-byte gauges equal JAX's ``_activation_memory`` and land
  in ``report.json`` and ``metrics.prom``.
* ``tune`` end to end at a tiny budget: the baseline probed first, the
  winner's MFU at least the baseline's, a failed probe reported with its
  status and never the winner, the emitted YAML training one step.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import yaml
from torch_port_helpers import REPO_ROOT, run_cli

from llmtrain_tpu import registry as jax_registry
from llmtrain_tpu.autotune import plan as jax_plan
from llmtrain_tpu.autotune import search as jax_search
from llmtrain_tpu.config import RunConfig as JaxRunConfig
from llmtrain_tpu.telemetry.profiling import resolve_peaks as jax_resolve_peaks
from llmtrain_tpu_torch.autotune import plan, search
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries
from llmtrain_tpu_torch.telemetry.profiling import MFU_RECONCILE_BAND, resolve_peaks

PRESETS = REPO_ROOT / "configs" / "presets"


def _preset(name: str) -> dict:
    return yaml.safe_load((PRESETS / f"{name}.yaml").read_text())


def _both(raw: dict):
    return JaxRunConfig.model_validate(raw), RunConfig.model_validate(raw)


def _gpt_raw(**model) -> dict:
    raw = _preset("gpt_tune_smoke")
    raw["model"].update(model)
    return raw


PLAN_GRID = [
    dict(mesh={"data": 8}, mb=4),
    dict(mesh={"data": 2, "fsdp": 2, "tensor": 2}, mb=4, zero=1),
    dict(mesh={"data": 2, "pipeline": 4}, mb=8, remat=True),
    dict(mesh={"data": 2, "sequence": 2, "expert": 2}, mb=2, zero=2),
    dict(mesh={"data": 4, "tensor": 2}, mb=4, tiers="offload:0-0,full:1-1"),
    dict(mesh={"data": 1}, mb=16, tiers="selective:*", devices=1),
]
LOSSES = [("dense", 8192), ("chunked_ce", 16), ("fused_ce", 8192)]


def _plans(case: dict, supports_pipeline: bool = True):
    caps = dict(n_heads=2, block_size=8, supports_pipeline=supports_pipeline, n_layers=2,
                pipeline_microbatches=4)
    kw = dict(mesh_sizes=case["mesh"], device_count=case.get("devices", 8),
              micro_batch_size=case["mb"], grad_accum_steps=2, remat=case.get("remat", False),
              zero_stage=case.get("zero", 0), activation_tiers=case.get("tiers", ""),
              model_name="gpt")
    return (jax_plan.resolve_plan(caps=jax_plan.ModelCaps(**caps), **kw),
            plan.resolve_plan(caps=plan.ModelCaps(**caps), **kw))


@pytest.mark.parametrize("case", range(len(PLAN_GRID)))
def test_memory_model_and_plan_object_are_jax_s(case: int) -> None:
    want, got = _plans(PLAN_GRID[case])
    assert got.key() == want.key()
    assert got.config_overrides() == want.config_overrides()
    assert got.describe_topology(num_processes=8) == want.describe_topology(num_processes=8)
    assert (got.data_parallel, got.model_parallel, got.global_micro_batch) == (
        want.data_parallel, want.model_parallel, want.global_micro_batch)
    assert plan.plan_layer_tiers(got, 2) == jax_plan.plan_layer_tiers(want, 2)
    for loss_impl, ce_chunk in LOSSES:
        kw = dict(n_params=123_457, d_model=64, n_layers=2, vocab_size=64, block_size=8,
                  dtype_bytes=2, param_dtype_bytes=4, loss_impl=loss_impl, ce_chunk=ce_chunk)
        assert plan.predict_hbm_bytes(got, **kw) == jax_plan.predict_hbm_bytes(want, **kw)
    jcfg, cfg = _both(_gpt_raw())
    assert search.analytic_candidate_cost(got, cfg) == jax_search.analytic_candidate_cost(
        want, jcfg)


def test_param_count_and_loss_resolution_are_jax_s() -> None:
    kw = dict(d_model=768, n_layers=12, d_ff=3072, vocab_size=50257, block_size=1024)
    for extra in ({}, {"tie_embeddings": False}, {"n_experts": 8}):
        assert plan.estimate_param_count(**kw, **extra) == jax_plan.estimate_param_count(
            **kw, **extra)
    for extra in ({}, {"loss_impl": "chunked_ce", "ce_chunk": 4096}, {"loss_impl": "bogus"}):
        raw = _gpt_raw()
        raw["model"]["extra"] = extra
        jcfg, cfg = _both(raw)
        assert plan.config_loss_impl(cfg) == jax_plan.config_loss_impl(jcfg)
    # The card's memory: the h100 row (a port divergence; JAX lists TPUs).
    assert search.resolve_hbm_limit("nvidia h100 80gb hbm3") == 80e9
    assert search.resolve_hbm_limit("TPU v5 lite") == jax_search.resolve_hbm_limit("TPU v5 lite")
    assert search.resolve_hbm_limit("cpu", 5e9) == 5e9


ENUM_CASES = {
    "full-grid-8": (dict(), 8, dict()),
    "no-mesh-search": (dict(), 4, dict(search_mesh=False, search_zero=False)),
    "tier-spec": (dict(extra={"activation_tiers": "full:*"}), 4, dict(search_zero=False)),
    "moe": (dict(name="gpt_moe", extra={"n_experts": 4}), 4, dict(search_remat=False)),
    "microbatches": (dict(), 2, dict(microbatch_candidates=[1, 3, 8])),
}


@pytest.mark.parametrize("case", sorted(ENUM_CASES))
def test_candidates_and_pruning_are_jax_s(case: str) -> None:
    model, devices, knobs = ENUM_CASES[case]
    jcfg, cfg = _both(_gpt_raw(**model))
    kw = dict(seed=11, **knobs)
    jc = jax_search.enumerate_candidates(jcfg, devices, **kw)
    pc = search.enumerate_candidates(cfg, devices, **kw)
    assert [c.key() for c in pc] == [c.key() for c in jc]
    peaks = {k: v for k, v in jax_resolve_peaks("cpu").items()}
    assert peaks == resolve_peaks("cpu")
    jax_registry.initialize_registries()
    initialize_registries()
    prune_kw = dict(device_count=devices, peaks=peaks, hbm_limit_bytes=2e6, max_probes=3)
    want = jax_search.prune_candidates(
        jc, jcfg, caps=jax_plan.caps_from_config(
            jcfg, jax_registry.get_model_adapter(jcfg.model.name)), **prune_kw)
    got = search.prune_candidates(
        pc, cfg, caps=plan.caps_from_config(cfg, get_model_adapter(cfg.model.name)), **prune_kw)
    assert got["enumerated"] == want["enumerated"]
    assert [c.key() for c in got["survivors"]] == [c.key() for c in want["survivors"]]
    assert got["pruned"] == want["pruned"] and got["pruned"]


def test_resume_constraint_prunes_as_jax() -> None:
    jcfg, cfg = _both(_gpt_raw())
    jbase = jax_plan.plan_from_config(jcfg, 4)
    base = plan.plan_from_config(cfg, 4)
    assert base.describe_topology() == jbase.describe_topology()
    peaks = resolve_peaks("cpu")
    kw = dict(device_count=4, peaks=peaks, hbm_limit_bytes=8e9, max_probes=50)
    want = jax_search.prune_candidates(
        jax_search.enumerate_candidates(jcfg, 4, seed=2), jcfg,
        caps=jax_plan.caps_from_config(jcfg), baseline_topology=jbase.describe_topology(), **kw)
    got = search.prune_candidates(
        search.enumerate_candidates(cfg, 4, seed=2), cfg, caps=plan.caps_from_config(cfg),
        baseline_topology=base.describe_topology(), **kw)
    assert got["pruned"] == want["pruned"]
    assert any("(resume)" in r["reason"] for r in got["pruned"])


@pytest.mark.parametrize("name", ["gpt_tune_smoke", "gpt_pipeline_smoke", "llama_smoke",
                                  "gpt_moe_smoke"])
def test_lowered_count_is_lowered_and_within_band_of_jax(name: str) -> None:
    raw = _preset(name)
    raw["distributed"] = {"enabled": False}
    jcfg, cfg = _both(raw)
    jax_registry.initialize_registries()
    want = jax_search.lowered_candidate_cost(jcfg, jax_plan.plan_from_config(
        jcfg, 1, adapter=jax_registry.get_model_adapter(jcfg.model.name)))
    got = search.lowered_candidate_cost(cfg, plan.plan_from_config(cfg, 1))
    assert got is not None and got["source"] == "lowered", name
    assert want is not None and want["source"] == "lowered"
    lo, hi = MFU_RECONCILE_BAND
    if name == "gpt_pipeline_smoke":
        # XLA's cost analysis counts a scan's body once: JAX's count of the
        # stacked model is one layer's, under the band. The port counts
        # every layer, within the band of PaLM's 6N model.
        analytic = jax_search.analytic_candidate_cost(
            jax_plan.plan_from_config(jcfg, 1, adapter=jax_registry.get_model_adapter(
                jcfg.model.name)), jcfg)
        assert want["flops"] / analytic["flops"] < lo
        want = analytic
    assert lo <= got["flops"] / want["flops"] <= hi, (got["flops"], want["flops"])
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["offload_bytes"] == want["offload_bytes"]


# --------------------------------------------------------------------------
# the plan command
# --------------------------------------------------------------------------


def _write(tmp_path: Path, raw: dict, name: str = "cfg") -> str:
    raw = {**raw, "output": {"root_dir": str(tmp_path / "runs")}}
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path)


@pytest.mark.parametrize("case", ["feasible", "pipeline", "over-limit", "infeasible-mesh"])
def test_plan_cli_is_jax_s(tmp_path, capsys, case: str) -> None:
    from llmtrain_tpu.cli import main as jax_main
    from llmtrain_tpu_torch.cli import main as port_main

    raw = _gpt_raw()
    argv_extra = ["--devices", "4"]
    if case == "pipeline":
        raw = _preset("gpt_pipeline_smoke")
        argv_extra = ["--devices", "8"]
    elif case == "over-limit":
        raw["tune"] = {**raw["tune"], "hbm_limit_bytes": 1000.0}
    elif case == "infeasible-mesh":
        raw["distributed"] = {"mesh": {"tensor": 3}}
    cfg = _write(tmp_path, raw)
    argv = ["plan", "--config", cfg, "--json", *argv_extra]
    want_code = run_cli(jax_main, argv)
    want = capsys.readouterr()
    got_code = run_cli(port_main, argv)
    got = capsys.readouterr()
    assert got_code == want_code == (0 if case in ("feasible", "pipeline") else 2)
    if case == "infeasible-mesh":
        assert json.loads(got.err)["error"] == json.loads(want.err)["error"]
        return
    got_payload, want_payload = json.loads(got.out), json.loads(want.out)
    assert sorted(got_payload) == sorted(want_payload)
    for key in ("plan", "predicted_hbm", "hbm_limit_bytes", "feasible", "roofline"):
        assert got_payload[key] == want_payload[key], key
    if case == "over-limit":
        assert "exceeds the" in json.loads(got.err.strip().splitlines()[-1])["error"]


# --------------------------------------------------------------------------
# the activation-byte gauges
# --------------------------------------------------------------------------


def test_activation_gauges_are_jax_s_and_reported(tmp_path, capsys) -> None:
    from llmtrain_tpu.registry import initialize_registries as jax_init
    from llmtrain_tpu.tracking.base import NullTracker
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.cli import main as port_main
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _gpt_raw(n_layers=4, remat=False)
    raw["model"]["extra"] = {"activation_tiers": "offload:0-1,full:2-3"}
    raw["trainer"].update(max_steps=2, log_every_steps=1)
    jcfg, cfg = _both(raw)
    jax_init()
    want = JaxTrainer(jcfg, None, NullTracker())._activation_memory()
    got = Trainer(cfg, None)._activation_memory()
    assert got == want and got["activation_bytes_offloaded"] > 0
    assert run_cli(port_main, ["train", "--config", _write(tmp_path, raw), "--run-id",
                               "g"]) == 0
    capsys.readouterr()
    run = tmp_path / "runs" / "g"
    memory = json.loads((run / "report.json").read_text())["memory"]
    assert memory["activation_bytes"] == got["activation_bytes"]
    assert memory["activation_bytes_offloaded"] == got["activation_bytes_offloaded"]
    prom = (run / "telemetry" / "metrics.prom").read_text()
    assert "activation_bytes" in prom and "activation_bytes_offloaded" in prom


# --------------------------------------------------------------------------
# tune
# --------------------------------------------------------------------------


def test_tune_probes_and_emits_a_config_that_trains(tmp_path, capsys, monkeypatch) -> None:
    """``run_tune`` on ``gpt_tune_smoke`` at its two probes, two steps each:
    the baseline first, the winner's MFU at least the baseline's, the
    emitted YAML the base config plus the winner's overrides, training one
    step. A second tune whose one survivor's probe cannot run reports it
    with its status and emits the baseline."""
    from llmtrain_tpu_torch.autotune import tune
    from llmtrain_tpu_torch.cli import main as port_main

    raw = _preset("gpt_tune_smoke")
    raw["tune"].update(probe_steps=2)
    raw["output"] = {"root_dir": str(tmp_path / "runs")}
    cfg = RunConfig.model_validate(raw)
    report = tune.run_tune(cfg, cfg.model_dump(), workdir=tmp_path / "w",
                           output_path=tmp_path / "tuned.yaml", device_count=1)
    measured = report["measured"]
    assert measured[0]["baseline"] and measured[0]["status"] == "ok"
    winner = report["winner"]
    assert winner["status"] == "ok" and winner["mfu"] >= measured[0]["mfu"]
    assert json.loads((tmp_path / "w" / "tune_report.json").read_text())["winner"] == winner
    emitted = yaml.safe_load((tmp_path / "tuned.yaml").read_text())
    assert emitted["trainer"]["max_steps"] == raw["trainer"]["max_steps"]  # no probe knob leaks
    emitted["trainer"].update(max_steps=1, warmup_steps=0)
    cfg_path = tmp_path / "emitted.yaml"
    cfg_path.write_text(yaml.safe_dump(emitted))
    assert run_cli(port_main, ["train", "--config", str(cfg_path), "--run-id", "t"]) == 0
    capsys.readouterr()
    assert math.isfinite(json.loads((tmp_path / "runs" / "t" / "report.json").read_text())
                         ["loss"]["final"])

    real = tune._probe_overrides

    def broken(p, **kw):
        out = real(p, **kw)
        if kw["run_id"] != "probe_baseline":
            out["trainer"]["micro_batch_size"] = 0  # the schema refuses it
        return out

    monkeypatch.setattr(tune, "_probe_overrides", broken)
    cfg = RunConfig.model_validate({**raw, "tune": {**raw["tune"], "max_probes": 1}})
    report = tune.run_tune(cfg, cfg.model_dump(), workdir=tmp_path / "w2",
                           output_path=tmp_path / "tuned2.yaml", device_count=1)
    failed = [m for m in report["measured"] if not m.get("baseline")]
    assert [m["status"] for m in failed] == ["invalid-config"]
    assert report["winner"]["key"] == report["baseline"]["key"]


def test_tune_cli_exits_2_for_an_infeasible_mesh(tmp_path, capsys) -> None:
    from llmtrain_tpu_torch.cli import main as port_main

    raw = _preset("gpt_tune_smoke")
    raw["distributed"] = {"mesh": {"tensor": 3}}
    assert run_cli(port_main, ["tune", "--config", _write(tmp_path, raw), "--json"]) == 2
    assert "infeasible plan" in json.loads(capsys.readouterr().err)["error"]
