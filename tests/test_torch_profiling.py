"""The port's cost attribution (llmtrain_tpu_torch/telemetry/profiling.py,
ops/cost.py) against the JAX package's, on the CPU.

* The pure functions — peaks, cost normalization, roofline class,
  gradient collective bytes, the ``perf_attribution`` block, its gauges,
  the top-ops table and its markdown — give JAX's dicts on the same input.
* The cost count of one train step at the test size: its matmul flops
  equal the closed form, each hand-written kernel appears under its own
  name with its closed-form flops and bytes, and its total flops over
  JAX's ``lower_cost_profile`` flops for the same config lie inside
  ``MFU_RECONCILE_BAND``.
* A counted step leaves the parameters, the optimizer state, the
  generators and the kernels' launch counts as they were, and touches no
  tensor off the ``meta`` device.
* ``profile --steps 2 --serve`` writes a report with JAX's keys, apart
  from the compiled executable's compile time and memory analysis, which
  the port does not have.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401
import yaml
from torch_port_helpers import run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.telemetry import profiling as jax_prof
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.ops import cost as kernel_cost
from llmtrain_tpu_torch.ops import flash_attention, fused_ce, fused_norm
from llmtrain_tpu_torch.telemetry import profiling as port_prof

PEAKS = {"peak_flops": 1e12, "hbm_bytes_per_sec": 1e11, "ici_bytes_per_sec": 1e10,
         "device_kind": "x"}
# Keys JAX's compiled-executable profile has and the port's count does not.
_PROFILE_DIVERGENCES = {"compile_time_s", "memory"}


@pytest.mark.parametrize("kind", [None, "cpu", "TPU v4", "TPU v5 lite", "tpu v5p", "weird"])
@pytest.mark.parametrize("overrides", [None, {"peak_flops": 5e14, "ici_bytes_per_sec": 0}])
def test_resolve_peaks_matches_jax(kind, overrides) -> None:
    assert port_prof.resolve_peaks(kind or "cpu", overrides) == \
        jax_prof.resolve_peaks(kind or "cpu", overrides)


def test_peak_table_keeps_jax_s_rows_and_adds_the_h100() -> None:
    extra = set(port_prof.DEVICE_PEAKS) - set(jax_prof.DEVICE_PEAKS)
    assert extra == {"h100"}
    for key, row in jax_prof.DEVICE_PEAKS.items():
        assert port_prof.DEVICE_PEAKS[key] == row
    h100 = port_prof.resolve_peaks("NVIDIA H100 80GB HBM3")
    assert (h100["peak_flops"], h100["hbm_bytes_per_sec"], h100["ici_bytes_per_sec"]) == \
        (989e12, 3.35e12, 900e9)
    assert port_prof.MFU_RECONCILE_BAND == jax_prof.MFU_RECONCILE_BAND


@pytest.mark.parametrize("raw", [None, [], {"flops": 10, "bytes accessed": 4.0, "x": "s"},
                                 [{"flops": 3.0, "transcendentals": 1}, {"flops": 9}],
                                 {"bytes_accessed": 7}, 5])
def test_cost_normalization_matches_jax(raw) -> None:
    assert port_prof.normalize_cost(raw) == jax_prof.normalize_cost(raw)
    assert port_prof.cost_summary(raw) == jax_prof.cost_summary(raw)


@pytest.mark.parametrize("flops,nbytes,coll", [(1e9, 1e6, 0.0), (1e6, 1e9, 0.0),
                                               (1e6, 1e6, 1e9), (0.0, 0.0, 0.0)])
def test_roofline_matches_jax(flops, nbytes, coll) -> None:
    kw = dict(flops=flops, bytes_accessed=nbytes, collective_bytes=coll, peaks=PEAKS)
    assert port_prof.classify_roofline(**kw) == jax_prof.classify_roofline(**kw)
    for sizes in ({}, {"data": 4}, {"data": 2, "fsdp": 2, "tensor": 4}):
        assert port_prof.gradient_collective_bytes(sizes, 4e6) == \
            jax_prof.gradient_collective_bytes(sizes, 4e6)


@pytest.mark.parametrize("case", ["full", "no-step-time", "no-palm", "unreconciled", "empty"])
def test_perf_attribution_block_matches_jax(case) -> None:
    exes = [{"name": "train_step", "flops": 6e9, "bytes_accessed": 3e8, "transcendentals": 1e4},
            {"name": "decode_B8", "flops": 1e8, "bytes_accessed": 9e8}, {}]
    kw = dict(executables=exes, peaks=PEAKS, n_chips=2, step_time_ms=120.0,
              tokens_per_step=4096.0, palm_flops_per_token=7.5e5, measured_mfu=0.31,
              collective_bytes=2e7, steps=4,
              span_totals={"data_wait": {"total_ms": 8.0}, "host_dispatch": {"total_ms": 40.0}})
    if case == "no-step-time":
        kw["step_time_ms"] = None
    elif case == "no-palm":
        kw["palm_flops_per_token"] = None
    elif case == "unreconciled":
        kw["palm_flops_per_token"] = 1.0
    elif case == "empty":
        kw["executables"] = []
    ours = port_prof.build_perf_attribution(**kw)
    assert ours == jax_prof.build_perf_attribution(**kw)
    assert port_prof.attribution_gauges(ours) == jax_prof.attribution_gauges(ours)


def test_top_ops_and_markdown_match_jax() -> None:
    parsed = {
        "ops": {"dot": {"count": 12, "flops": 9e9, "bytes_accessed": 1e8, "transcendentals": 0},
                "add": {"count": 40, "flops": 1e6, "bytes_accessed": 4e8, "transcendentals": 0},
                "tuple": {"count": 3, "flops": 0, "bytes_accessed": 0, "transcendentals": 0},
                "exp": {"count": 2, "flops": 5e5, "bytes_accessed": 1e6,
                        "transcendentals": 5e5}},
        "totals": {"flops": 9.0015e9, "bytes_accessed": 5.01e8},
    }
    for k in (1, 2, 10):
        rows = port_prof.top_ops(parsed, PEAKS, k=k)
        assert rows == jax_prof.top_ops(parsed, PEAKS, k=k)
        assert port_prof.render_top_ops_markdown(rows) == jax_prof.render_top_ops_markdown(rows)
    # The hand-written kernels are listed whatever their rank.
    assert [r["op"] for r in port_prof.top_ops(parsed, PEAKS, k=1, always={"exp"})] == \
        ["dot", "exp"]


# ---------------------------------------------------------------- the count


def _raw(tmp_path: Path, **model_extra) -> dict:
    corpus = tmp_path / "corpus"
    corpus.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(2):
        words = rng.choice(["def", "class", "return", "self", "x", "=", "\n"], size=800)
        (corpus / f"f{i}.py").write_text(" ".join(words))
    return {
        "schema_version": 1,
        "run": {"name": "prof", "seed": 3, "device": "cpu", "deterministic": False},
        "model": {"name": "gpt", "block_size": 32, "d_model": 64, "n_layers": 2, "n_heads": 4,
                  "d_ff": 128, "dropout": 0.0, "attention": "flash",
                  "extra": {"tokenizer": "byte", **model_extra}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                 "extra": {"globs": [str(corpus / "*.py")], "val_fraction": 0.1}},
        "trainer": {"max_steps": 2, "micro_batch_size": 8, "grad_accum_steps": 2, "lr": 3e-3,
                    "warmup_steps": 1, "log_every_steps": 1, "eval_every_steps": 2,
                    "save_every_steps": 2},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "logging": {"level": "INFO", "json_output": True, "log_to_file": False},
        "output": {"root_dir": str(tmp_path / "runs")},
    }


def _trainer(tmp_path: Path, raw: dict, steps: int = 1):
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.training.trainer import Trainer

    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    trainer = Trainer(load_and_validate_config(path)[0], None)
    trainer.fit(steps)
    return trainer


def _rows(profile: dict) -> dict[str, dict]:
    return {r["op"]: r for r in profile["top_ops"]}


@pytest.mark.parametrize("extra", [{}, {"fused_norm": True, "loss_impl": "fused_ce"}],
                         ids=["flash", "flash-fused-norm-fused-ce"])
def test_step_count_matches_the_closed_forms(tmp_path, extra) -> None:
    raw = _raw(tmp_path, **extra)
    trainer = _trainer(tmp_path, raw)
    prof = trainer.train_step_profile(peaks=port_prof.resolve_peaks("cpu"), full=True,
                                      top_k=1000)
    assert prof is not None and set(prof) == {
        "flops", "bytes_accessed", "transcendentals", "name", "lower_time_s",
        "collective_bytes", "top_ops", "roofline"}
    rows = _rows(prof)
    m = raw["model"]
    accum, micro, t = raw["trainer"]["grad_accum_steps"], raw["trainer"]["micro_batch_size"], 32
    n, d, ff, layers, v = micro * t, m["d_model"], m["d_ff"], m["n_layers"], 256
    h, hd = m["n_heads"], m["d_model"] // m["n_heads"]
    # Forward 2·N·(4d² + 2·d·ff) a layer; the backward's dX and dW twice
    # that; the tied lm head 2·N·d·V forward and twice that backward, all
    # per micro-batch. The fused CE does the lm head in its own kernels.
    layer = 6 * n * (4 * d * d + 2 * d * ff) * layers
    head = 0 if extra else 6 * n * d * v
    matmul = sum(rows[op]["flops"] for op in ("mm", "addmm", "bmm") if op in rows)
    assert matmul == accum * (layer + head)
    assert prof["flops"] == sum(r["flops"] for r in prof["top_ops"])
    elt = 4  # float32
    fwd = kernel_cost.flash_fwd_cost(micro, t, h, h, hd, elt)
    dq, dkdv = kernel_cost.flash_bwd_costs(micro, t, h, h, hd, elt)
    want = {"flash_attention_fwd": (fwd, layers), "flash_attention_bwd_dq": (dq, layers),
            "flash_attention_bwd_dkdv": (dkdv, layers)}
    if extra:
        ln = dict(residual=True)
        want["fused_norm_fwd"] = (
            tuple(a + b for a, b in zip(kernel_cost.norm_fwd_cost(n, d, elt, residual=False),
                                        kernel_cost.norm_fwd_cost(n, d, elt, **ln))), layers)
        want["fused_norm_bwd"] = (
            tuple(a + b for a, b in zip(kernel_cost.norm_bwd_cost(n, d, elt, gs=False),
                                        kernel_cost.norm_bwd_cost(n, d, elt, gs=True))), layers)
        for name, cost in zip(("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"),
                              kernel_cost.ce_costs(n, d, v, elt)):
            want[name] = (cost, 1)
    for name, ((flops, nbytes), per_micro) in want.items():
        calls = accum * per_micro
        if name.startswith("fused_norm"):
            # one call of each flavour per layer: the cost above is the pair's
            assert rows[name]["count"] == 2 * calls, name
            assert rows[name]["flops"] == accum * layers * flops, name
            assert rows[name]["bytes_accessed"] == accum * layers * nbytes, name
            continue
        assert rows[name]["count"] == calls, name
        assert rows[name]["flops"] == calls * flops and rows[name]["bytes_accessed"] == \
            calls * nbytes, name
        assert rows[name]["flops"] > 0


def test_step_count_reconciles_with_jax_s_lowered_flops(tmp_path) -> None:
    from llmtrain_tpu.config import load_and_validate_config as jax_load
    from llmtrain_tpu.registry import initialize_registries
    from llmtrain_tpu.tracking.base import NullTracker
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer

    raw = _raw(tmp_path)
    devices = len(jax.devices())
    jax_raw = json.loads(json.dumps(raw))
    jax_raw["trainer"]["micro_batch_size"] //= devices
    path = tmp_path / "jax.yaml"
    path.write_text(yaml.safe_dump(jax_raw, sort_keys=False))
    initialize_registries()
    jax_trainer = JaxTrainer(jax_load(path)[0], None, NullTracker())
    jax_trainer.fit(1)
    lowered = jax_prof.lower_cost_profile(
        jax_trainer._jit_train_step,
        (jax_trainer._state, jax_trainer._batch_struct, jax.random.key(3)),
        name="train_step",
    )
    ours = _trainer(tmp_path, raw).train_step_profile(peaks=port_prof.resolve_peaks("cpu"))
    ratio = ours["flops"] / lowered["flops"]
    lo, hi = port_prof.MFU_RECONCILE_BAND
    assert lo <= ratio <= hi, (ours["flops"], lowered["flops"])
    assert set(ours) == set(lowered)


def test_a_counted_step_changes_nothing(tmp_path) -> None:
    raw = _raw(tmp_path)
    raw["model"].update(attention="dense", dropout=0.1)
    trainer = _trainer(tmp_path, raw)
    params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.optimizer.state_dict()
    rng = torch.random.get_rng_state()
    np_rng = np.random.get_state()[1].copy()
    launches = [f.launches for f in (flash_attention.flash_attention_fwd,
                                     fused_ce.fused_ce_fwd, fused_norm.fused_norm_bwd)]
    step = trainer.state.step
    prof = trainer.train_step_profile(peaks=port_prof.resolve_peaks("cpu"), full=True,
                                      top_k=1000)
    # The dropout draws were counted (on meta tensors, from no generator state).
    assert prof is not None and _rows(prof)["rand"]["count"] > 0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, params[k]) and v.device.type == "cpu", k
    after = trainer.state.optimizer.state_dict()
    assert int(after["count"]) == int(opt["count"]) and trainer.state.step == step
    for name in opt["mu"]:
        np.testing.assert_array_equal(after["mu"][name], opt["mu"][name])
    assert torch.equal(torch.random.get_rng_state(), rng)
    assert np.array_equal(np.random.get_state()[1], np_rng)
    assert launches == [f.launches for f in (flash_attention.flash_attention_fwd,
                                             fused_ce.fused_ce_fwd, fused_norm.fused_norm_bwd)]


def test_the_count_refuses_a_real_tensor() -> None:
    """Anything off the meta device inside a count aborts it (None): no
    kernel runs and nothing is allocated on a device."""
    real = torch.ones(4)
    assert port_prof.count_cost_profile(lambda: real * 2, name="x") is None
    assert port_prof.count_cost_profile(
        lambda: torch.zeros(3, device="cpu") + 1, name="y") is None
    meta = torch.empty(4, 4, device="meta")
    ok = port_prof.count_cost_profile(lambda: meta @ meta, name="z")
    assert ok["flops"] == 2 * 4 * 4 * 4 and ok["bytes_accessed"] == 3 * 16 * 4


def test_meta_module_keeps_ties_and_allocates_nothing() -> None:
    from llmtrain_tpu_torch.models.gpt import GPT
    from llmtrain_tpu_torch.ops.quant import quantize_model

    model = GPT(vocab_size=61, block_size=16, d_model=64, n_layers=1, n_heads=4, d_ff=128)
    copy = port_prof.meta_module(model)
    assert copy.vocab_matrix() is copy.token_embedding.weight
    assert len(list(copy.parameters())) == len(list(model.parameters()))
    quantize_model(model, min_size=1024)
    copy = port_prof.meta_module(model)
    for t in copy.state_dict().values():
        assert t.device.type == "meta"
    for mod in copy.modules():
        for value in vars(mod).values():
            for t in port_prof._tensors_of(value):
                assert t.device.type == "meta"
    assert next(model.parameters()).device.type == "cpu"


# ---------------------------------------------------------------- the command


def _profile_keys(report: dict) -> dict:
    exes = {e["name"]: set(e) - _PROFILE_DIVERGENCES for e in report["executables"]}
    rows = {tuple(sorted(r)) for e in report["executables"] for r in e["top_ops"]}
    return {
        "top": set(report),
        "probe": set(report["probe"]),
        "peaks": set(report["peaks"]),
        "perf": set(report["perf_attribution"]),
        "mfu": set(report["perf_attribution"]["mfu"]),
        "split": set(report["perf_attribution"]["step_time_split_ms"]),
        "exes": exes,
        "rows": rows,
        "memory": set(report["memory"]) - {"compiled_train_step"},
        "schema": report["schema"],
    }


def test_profile_command_writes_jax_s_report(tmp_path, capsys) -> None:
    raw = _raw(tmp_path)
    raw["telemetry"] = {}
    path = tmp_path / "prof.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    reports = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name / "profile_report.json"
        argv = ["profile", "--config", str(path), "--steps", "2", "--serve", "--output", str(out)]
        assert run_cli(main, argv) == 0, capsys.readouterr().err[-2000:]
        printed = capsys.readouterr().out
        assert printed.startswith(f"profile report: {out}")
        reports.append(json.loads(out.read_text()))
    jax_r, port_r = reports
    assert _profile_keys(port_r) == _profile_keys(jax_r)
    assert port_r["perf_attribution"]["mfu"]["reconciled"] is True
    train = {r["op"]: r for r in port_r["executables"][0]["top_ops"]}
    for kernel in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert train[kernel]["count"] == 2 * raw["model"]["n_layers"], kernel
    assert port_r["memory"]["monitor_source"] == "host_rss"
    assert run_cli(port_main, ["profile", "--config", str(path), "--steps", "0"]) == 2
    assert run_cli(jax_main, ["profile", "--config", str(path), "--steps", "0"]) == 2
    assert "--steps must be >= 1" in capsys.readouterr().err
