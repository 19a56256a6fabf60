"""The port's pipeline schedule and ``gpt_pipeline`` model on the CPU,
against JAX's (``llmtrain_tpu/parallel/pipeline.py``,
``models/gpt_pipeline.py``, ``interop/pipeline_convert.py``).

* The schedule, its stages in lockstep in one process
  (``gpipe_on_one_device``), against JAX's ``gpipe_apply`` on a
  ``{pipeline: 4, data: 2}`` mesh of the 8 virtual CPU devices, forward
  and gradients: a tanh stack at 1, 2 and 4 microbatches and interleaved
  (two chunks a stage); the model's own stage (``make_stage_fn``) masked,
  windowed, grouped-query, dense and flash (JAX's flash through its CPU
  path, the port's through its kernels' plain versions); the degree-one
  path; every ``ValueError`` with JAX's words.
* The model with no mesh against JAX's: logits and gradients, with and
  without remat, ``assume_packed``; the adapter's refusals, batch divisor
  and mesh checks; a real indivisible batch on a pipeline mesh raises.
* ``pipeline_convert`` equal to JAX's on numpy, the carry-over round trip
  exact, ``to_gpt`` within the logits band, and ``generate`` from a
  pipeline checkpoint equal to ``generate`` of the same weights imported
  as ``gpt``.

Bands: logits 2e-5; gradients atol 1e-5, rtol 1e-4.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh
from torch_port_helpers import random_params, run_cli

from llmtrain_tpu.config import RunConfig as JaxRunConfig
from llmtrain_tpu.interop import pipeline_convert as jax_convert
from llmtrain_tpu.models.gpt_pipeline import PipelineGPT as JaxPipelineGPT
from llmtrain_tpu.models.gpt_pipeline import PipelineGPTAdapter as JaxAdapter
from llmtrain_tpu.models.gpt_pipeline import make_stage_fn as jax_make_stage_fn
from llmtrain_tpu.parallel.pipeline import gpipe_apply as jax_gpipe_apply
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.distributed.mesh import DeviceMesh, set_active_mesh
from llmtrain_tpu_torch.interop import (
    flax_params_to_state_dict,
    pipeline_convert,
    state_dict_to_flax_params,
)
from llmtrain_tpu_torch.models.gpt_pipeline import PipelineGPT, PipelineGPTAdapter, make_stage_fn
from llmtrain_tpu_torch.parallel import pipeline as pp

LOGIT_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
MODEL = dict(vocab_size=32, block_size=16, d_model=32, n_layers=4, n_heads=4, d_ff=64)


def _mesh(pipeline: int = 4, data: int = 2) -> Mesh:
    devs = np.array(jax.devices()[: pipeline * data]).reshape(pipeline, data)
    return Mesh(devs, ("pipeline", "data"))


def _jax_tanh(p, h):
    def layer(h, lp):
        return jnp.tanh(h @ lp[0] + lp[1]), None

    h, _ = jax.lax.scan(layer, h, (p["w"], p["b"]))
    return h


def _torch_tanh(p, h):
    for w, b in zip(p["w"], p["b"]):
        h = torch.tanh(h @ w + b)
    return h


def _t(tree):
    return {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in tree.items()}


def _jax_run(stage_fn, params, x, cot, mask=None, **kw):
    """JAX's gpipe_apply on the mesh: the output and the gradients of
    <output, cot> for params and x."""
    mesh = _mesh()

    def f(p, x):
        y, vjp = jax.vjp(lambda p, x: jax_gpipe_apply(stage_fn, p, x, mesh, mask=mask, **kw),
                         p, x)
        return y, *vjp(cot)

    with mesh:
        y, g_p, g_x = jax.jit(f)(params, x)
    return np.asarray(y), jax.device_get(g_p), np.asarray(g_x)


def _port_run(stage_fn, params, x, cot, mask=None, **kw):
    p, xt = _t(params), torch.from_numpy(np.array(x)).requires_grad_()
    m = None if mask is None else torch.from_numpy(np.array(mask))
    y = pp.gpipe_on_one_device(stage_fn, p, xt, 4, mask=m, **kw)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [*p.values(), xt])
    return (y.detach().numpy(), {k: g.numpy() for k, g in zip(p, grads[:-1])},
            grads[-1].numpy())


def _assert_same(port, ref) -> None:
    y, g_p, g_x = port
    ry, rg_p, rg_x = ref
    np.testing.assert_allclose(y, ry, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(g_x, rg_x, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for k in rg_p:
        np.testing.assert_allclose(g_p[k], np.asarray(rg_p[k]), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=k)


def _tanh_case(n_layers: int, seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(n_layers, 16, 16)) * 0.1).astype(np.float32),
              "b": (rng.normal(size=(n_layers, 16)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(8, 4, 16)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return params, x, cot


@pytest.mark.parametrize("n_micro,v", [(1, 1), (2, 1), (4, 1), (4, 2)],
                         ids=["gpipe-m1", "gpipe-m2", "gpipe-m4", "interleaved-v2"])
def test_schedule_matches_jax_gpipe(n_micro: int, v: int) -> None:
    params, x, cot = _tanh_case(8, seed=n_micro * 10 + v)
    kw = dict(n_microbatches=n_micro, virtual_chunks=v)
    ref = _jax_run(_jax_tanh, params, x, cot, **kw)
    for remat in (True, False):
        _assert_same(_port_run(_torch_tanh, params, x, cot, remat_stage=remat, **kw), ref)


STAGE_CASES = {
    "masked-dense": dict(attention="dense", masked=True),
    "masked-flash": dict(attention="flash", masked=True),
    "windowed-dense": dict(attention="dense", window=3),
    "windowed-flash": dict(attention="flash", window=3, masked=True),
    "gqa-flash": dict(attention="flash", n_kv_heads=2, masked=True),
    "gqa-interleaved": dict(attention="dense", n_kv_heads=2, v=2, n_layers=8),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_model_stage_on_the_schedule_matches_jax(case: str) -> None:
    spec = dict(STAGE_CASES[case])
    attention, window = spec["attention"], spec.get("window", 0)
    v, n_layers = spec.get("v", 1), spec.get("n_layers", 4)
    jmodel = JaxPipelineGPT(**{**MODEL, "n_layers": n_layers}, attention=attention,
                            n_kv_heads=spec.get("n_kv_heads", 0), sliding_window=window)
    tree = random_params(jmodel, jnp.zeros((1, 16), jnp.int32), seed=3)
    blocks = {k: np.asarray(v_) for k, v_ in tree.items() if not isinstance(v_, dict)
              and k not in ("ln_f_scale", "ln_f_bias")}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 16, 32)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mask = None
    if spec.get("masked"):
        mask = np.ones((8, 16), np.int32)
        mask[1, 11:] = 0
        mask[6, 4:] = 2  # a second segment
    n_micro = 4 if v > 1 else 2
    kw = dict(n_microbatches=n_micro, virtual_chunks=v)
    ref = _jax_run(jax_make_stage_fn(attention=attention, dtype=jnp.float32, window=window),
                   blocks, x, cot, mask=None if mask is None else jnp.asarray(mask), **kw)
    got = _port_run(make_stage_fn(attention=attention, dtype=torch.float32, window=window),
                    blocks, x, cot, mask=mask, **kw)
    _assert_same(got, ref)


def test_degree_one_is_the_stage_itself() -> None:
    params, x, cot = _tanh_case(4, seed=7)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("pipeline", "data"))
    with mesh:
        want = np.asarray(jax_gpipe_apply(_jax_tanh, params, x, mesh, n_microbatches=4))
    got = pp.gpipe_apply(_torch_tanh, _t(params), torch.from_numpy(x), None, n_microbatches=4)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert pp.pipeline_degree(None) == 1
    assert pp.pipeline_degree(DeviceMesh({"data": 2, "pipeline": 4, "fsdp": 1, "tensor": 1,
                                          "sequence": 1, "expert": 1}, 0)) == 4


ERROR_CASES = {
    "no-microbatches": dict(n_microbatches=0),
    "no-chunks": dict(n_microbatches=2, virtual_chunks=0),
    "interleaved-too-few-microbatches": dict(n_microbatches=2, virtual_chunks=2),
    "layers-indivisible": dict(n_microbatches=4, virtual_chunks=3),
    "batch-indivisible": dict(n_microbatches=2, batch=6),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_value_errors_are_jax_s(case: str) -> None:
    kw = dict(ERROR_CASES[case])
    batch = kw.pop("batch", 8)
    params, x, _ = _tanh_case(8, seed=1)
    x = x[:batch]
    mesh = _mesh()
    with mesh, pytest.raises(ValueError) as want:
        jax_gpipe_apply(_jax_tanh, params, x, mesh, **kw)
    # JAX checks each data shard's rows: the port's one-process stages
    # hold one shard of half the batch.
    x_port = torch.from_numpy(x[: batch // 2] if case == "batch-indivisible" else x)
    with pytest.raises(ValueError) as got:
        pp.gpipe_on_one_device(_torch_tanh, _t(params), x_port, 4, **kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _models(seed: int = 0, **kw):
    jmodel = JaxPipelineGPT(**MODEL, **kw)
    tree = random_params(jmodel, jnp.zeros((1, 16), jnp.int32), seed=seed)
    port = PipelineGPT(**MODEL, **kw)
    port.load_state_dict(flax_params_to_state_dict(tree))
    return jmodel, tree, port


def _batch(seed: int = 4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, MODEL["vocab_size"], (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[2, 12:] = 0
    return {"input_ids": ids, "labels": np.roll(ids, -1, axis=1), "attention_mask": mask}


@pytest.mark.parametrize("attention,n_kv_heads,remat,tied", [
    ("dense", 0, False, True), ("flash", 0, True, True), ("flash", 2, True, False),
    ("dense", 2, False, False)], ids=["dense-mha", "flash-mha-remat", "flash-gqa-untied",
                                      "dense-gqa-untied"])
def test_model_matches_jax(attention: str, n_kv_heads: int, remat: bool, tied: bool) -> None:
    kw = dict(attention=attention, n_kv_heads=n_kv_heads, remat=remat, tie_embeddings=tied)
    jmodel, tree, port = _models(**kw)
    batch = _batch()
    jadapter = JaxAdapter()
    want_logits = np.asarray(jmodel.apply({"params": tree}, batch["input_ids"],
                                          batch["attention_mask"]))

    def loss(p):
        ls, tk = jadapter.compute_loss_components(jmodel, p, {k: jnp.asarray(v)
                                                              for k, v in batch.items()})
        return jnp.sum(ls) / jnp.sum(tk)

    want_grads = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax.grad(loss)(tree))))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = port(tb["input_ids"].long(), tb["attention_mask"])
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    port.train()
    ls, tk = PipelineGPTAdapter().compute_loss_components(port, tb)
    (ls.sum() / tk.sum()).backward()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_assume_packed_drops_the_mask() -> None:
    jmodel, tree, port = _models(assume_packed=True)
    batch = _batch()
    want = np.asarray(jmodel.apply({"params": tree}, batch["input_ids"],
                                   batch["attention_mask"]))
    ids = torch.from_numpy(batch["input_ids"]).long()
    masked = port(ids, torch.from_numpy(batch["attention_mask"])).detach()
    assert torch.equal(masked, port(ids).detach())
    np.testing.assert_allclose(masked.numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _cfg_raw(mesh: dict | None = None, **model) -> dict:
    extra = {"tokenizer": "byte", "pipeline_microbatches": 2, **model.pop("extra", {})}
    return {"schema_version": 1, "run": {"name": "pp", "device": "cpu"},
            "model": {"name": "gpt_pipeline", "dropout": 0.0, **MODEL, **model, "extra": extra},
            "data": {"name": "dummy_text"},
            "trainer": {"max_steps": 2, "micro_batch_size": 4, "warmup_steps": 0},
            "distributed": {"mesh": mesh or {}},
            "mlflow": {"enabled": False}}


REFUSALS = {
    "dropout": dict(dropout=0.1),
    "ring": dict(attention="ring"),
    "fused_ce": dict(extra={"loss_impl": "fused_ce"}),
    "unknown-loss": dict(extra={"loss_impl": "sparse"}),
    "z_loss": dict(extra={"z_loss": -1.0}),
    "kv-heads": dict(extra={"n_kv_heads": 3}),
    "window": dict(extra={"sliding_window": -2}),
    "kv-cache": dict(extra={"kv_cache_dtype": "fp8"}),
    "microbatches": dict(extra={"pipeline_microbatches": 0}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_build_refusals_are_jax_s(case: str) -> None:
    raw = _cfg_raw(**REFUSALS[case])
    with pytest.raises(ValueError) as want:
        JaxAdapter().build_model(JaxRunConfig.model_validate(raw))
    with pytest.raises(ValueError) as got:
        PipelineGPTAdapter().build_model(RunConfig.model_validate(raw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sizes,micro,kv_heads", [
    ({"pipeline": 4, "data": 2}, 4, 0), ({"pipeline": 2, "tensor": 2, "data": 2}, 4, 2),
    ({"pipeline": 4, "data": 2}, 3, 0), ({"pipeline": 2, "tensor": 4}, 4, 2),
    ({"data": 8}, 4, 0)], ids=["pp", "pp-tp", "micro-indivisible", "kv-indivisible", "no-pp"])
def test_batch_divisor_and_mesh_checks_are_jax_s(sizes: dict, micro: int, kv_heads: int) -> None:
    from llmtrain_tpu.config.schemas import MeshConfig as JaxMeshConfig
    from llmtrain_tpu.distributed import build_mesh as jax_build_mesh

    raw = _cfg_raw(sizes, extra={"n_kv_heads": kv_heads})
    raw["trainer"]["micro_batch_size"] = micro
    jcfg, cfg = JaxRunConfig.model_validate(raw), RunConfig.model_validate(raw)
    jmesh = jax_build_mesh(JaxMeshConfig(**sizes), jax.devices()[:8])
    axes = {a: sizes.get(a, 1) for a in jmesh.axis_names}
    assert PipelineGPTAdapter().batch_divisor(cfg, axes) == JaxAdapter().batch_divisor(jcfg,
                                                                                       jmesh)
    try:
        JaxAdapter().validate_mesh(jcfg, jmesh)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            PipelineGPTAdapter().validate_mesh(cfg, axes)
        assert str(got.value) == str(exc)
    else:
        PipelineGPTAdapter().validate_mesh(cfg, axes)


def test_real_indivisible_batch_raises_on_a_pipeline_mesh() -> None:
    port = PipelineGPT(**MODEL, n_microbatches=4)
    mesh = DeviceMesh({"data": 2, "fsdp": 1, "tensor": 1, "sequence": 1, "pipeline": 4,
                       "expert": 1}, 0)
    set_active_mesh(mesh)
    try:
        with pytest.raises(ValueError, match=r"gpt_pipeline: batch 6 is not divisible by data "
                                             r"shards x microbatches \(8\) on a 4-stage"):
            port(torch.zeros((3, 16), dtype=torch.long))
    finally:
        set_active_mesh(None)


# --------------------------------------------------------------------------
# conversion
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv_heads,tied", [(0, True), (2, False)], ids=["mha", "gqa-untied"])
def test_pipeline_convert_and_carry_over_are_exact(n_kv_heads: int, tied: bool) -> None:
    jmodel, tree, port = _models(n_kv_heads=n_kv_heads, tie_embeddings=tied)
    gpt_tree = jax_convert.pipeline_params_to_gpt(tree)
    got = pipeline_convert.pipeline_params_to_gpt(tree)
    flat_want = jax.tree_util.tree_leaves_with_path(gpt_tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf))
    back = pipeline_convert.gpt_params_to_pipeline(got)
    want_back = jax_convert.gpt_params_to_pipeline(gpt_tree)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_back):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    assert pipeline_convert.is_pipeline_tree(tree) and not pipeline_convert.is_pipeline_tree(got)
    assert jax_convert.is_pipeline_tree(tree)
    # The carry-over round trip: JAX tree -> port state dict -> JAX tree.
    again = state_dict_to_flax_params(port.state_dict(), n_heads=MODEL["n_heads"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        node = again
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # The plain GPT of the same weights decodes the same logits.
    ids = torch.from_numpy(_batch()["input_ids"]).long()
    np.testing.assert_allclose(port.to_gpt()(ids).detach().numpy(), port(ids).detach().numpy(),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_generate_from_a_pipeline_checkpoint_is_gpt_s(tmp_path, capsys) -> None:
    """Train two steps, export the checkpoint as the reference torch GPT,
    import it into a ``gpt`` config and back into the pipeline one:
    ``generate`` is the same tokens from all three checkpoints."""
    from llmtrain_tpu_torch.cli import main as port_main

    raw = _cfg_raw(extra={"sliding_window": 6})
    raw["trainer"].update(log_every_steps=1, save_every_steps=2, eval_every_steps=2)
    raw["output"] = {"root_dir": str(tmp_path / "runs")}
    gpt_raw = {**raw, "model": {**raw["model"], "name": "gpt",
                                "extra": {"tokenizer": "byte", "sliding_window": 6}}}
    paths = {}
    for name, r in (("pipe", raw), ("gpt", gpt_raw)):
        paths[name] = tmp_path / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(r))
    pipe, gpt, torch_file = str(paths["pipe"]), str(paths["gpt"]), str(tmp_path / "ex.pt")
    assert run_cli(port_main, ["train", "--config", pipe, "--run-id", "r"]) == 0
    assert run_cli(port_main, ["export-checkpoint", "--config", pipe, "--from", "r",
                               "--output", torch_file]) == 0
    for cfg, out in ((gpt, "as_gpt"), (pipe, "as_pipe")):
        assert run_cli(port_main, ["import-checkpoint", "--config", cfg, "--input", torch_file,
                                   "--output", str(tmp_path / out)]) == 0
    capsys.readouterr()
    completions = []
    for cfg, ckpt in ((pipe, "r"), (gpt, str(tmp_path / "as_gpt")),
                      (pipe, str(tmp_path / "as_pipe"))):
        assert run_cli(port_main, ["generate", "--config", cfg, "--from", ckpt, "--prompt-ids",
                                   "3,1,4,1,5", "--max-new-tokens", "10", "--json"]) == 0
        completions.append(json.loads(capsys.readouterr().out)["completion_ids"])
    assert completions[0] == completions[1] == completions[2] and len(completions[0]) == 10
