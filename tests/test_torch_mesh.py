"""The port's mesh plan and sharding rules against JAX's
(llmtrain_tpu/autotune/plan.py, llmtrain_tpu/parallel/sharding.py).

* ``plan_from_config`` raises in exactly the cases JAX's raises, with
  its message, and otherwise resolves the same axes; the port's CLI
  exits 2 for a mesh that does not fit its processes, naming the device
  count (a pipeline axis too, since the pipeline is ported).
* The split of every parameter (the spec of its flax leaf through the
  port's layouts, repairs included) equals JAX's ``NamedSharding`` spec,
  for the GPT, GQA llama, ``gpt_moe`` and ``gpt_pipeline`` trees on
  ``{fsdp: 2, tensor: 2}``, ``{tensor: 4}``, ``{sequence: 2, data: 2}``,
  ``{expert: 4, data: 2}``, ``{pipeline: 4, data: 2}`` and ``{pipeline: 2,
  tensor: 2, data: 2}``.
* ZeRO's partition over data x fsdp x expert, as the trainer takes it on
  each rank, holds the elements of JAX's ``opt_state_shardings`` on the
  same trees and meshes.
* The rank layout: rank r holds the mesh coordinates of JAX's device r.
"""

from __future__ import annotations

import itertools
import math

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.linen import meta as nn_meta
from torch_port_helpers import run_cli

from llmtrain_tpu.autotune.plan import MeshPlanError as JaxMeshPlanError
from llmtrain_tpu.autotune.plan import plan_from_config as jax_plan_from_config
from llmtrain_tpu.config.schemas import MeshConfig as JaxMeshConfig
from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.distributed import build_mesh as jax_build_mesh
from llmtrain_tpu.parallel.sharding import opt_state_shardings as jax_opt_state_shardings
from llmtrain_tpu.parallel.sharding import state_shardings as jax_state_shardings
from llmtrain_tpu_torch.autotune.plan import MeshPlanError, plan_from_config
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.distributed.mesh import DeviceMesh
from llmtrain_tpu_torch.interop import state_dict_to_flax_params
from llmtrain_tpu_torch.parallel.sharding import (
    data_parallel_degree,
    mesh_axis_sizes,
    param_layout,
    state_shardings,
)
from llmtrain_tpu_torch.resilience.elastic import describe_topology


def _raw(model: dict | None = None, mesh: dict | None = None, **trainer) -> dict:
    return {
        "run": {"name": "plan", "device": "cpu"},
        "model": {"name": "gpt", "block_size": 32, "d_model": 32, "n_layers": 2,
                  "n_heads": 4, "d_ff": 64, "vocab_size": 64, "dropout": 0.0,
                  **(model or {})},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 2, "warmup_steps": 0, "micro_batch_size": 4, **trainer},
        "mlflow": {"enabled": False},
        "distributed": {"mesh": mesh or {}},
    }


PLAN_CASES = {
    "data-only": (_raw(), 4),
    "wildcard-fills": (_raw(mesh={"data": -1, "tensor": 2}), 8),
    "two-wildcards": (_raw(mesh={"data": -1, "fsdp": -1}), 8),
    "indivisible-wildcard": (_raw(mesh={"data": -1, "tensor": 3}), 8),
    "product-misses": (_raw(mesh={"data": 2, "tensor": 2}), 8),
    "one-process": (_raw(mesh={"expert": 4, "data": 2}), 1),
    "ring-block": (_raw({"attention": "ring", "block_size": 30}, {"data": 1, "sequence": 4}), 4),
    "ulysses-heads": (_raw({"attention": "ulysses", "n_heads": 2, "d_model": 32},
                           {"data": 1, "sequence": 4}), 4),
    "ulysses-ok": (_raw({"attention": "ulysses"}, {"data": 2, "sequence": 2}), 4),
    "dense-sequence": (_raw({"block_size": 30}, {"data": 1, "sequence": 4}), 4),
    "tensor-heads": (_raw({"n_heads": 2}, {"data": 1, "tensor": 4}), 4),
    "tensor-kv-heads": (_raw({"name": "llama", "extra": {"n_kv_heads": 2}},
                             {"data": 1, "tensor": 4}), 4),
    "experts": (_raw({"name": "gpt_moe", "extra": {"n_experts": 6}},
                     {"data": 2, "expert": 4}), 8),
    "experts-ok": (_raw({"name": "gpt_moe", "extra": {"n_experts": 8}},
                        {"data": 2, "expert": 4}), 8),
    "dense-expert-axis": (_raw(mesh={"data": 2, "expert": 4}), 8),
    "pipeline": (_raw(mesh={"data": 1, "pipeline": 2}), 2),
    "tiers-and-remat": (_raw({"remat": True, "extra": {"activation_tiers": "full:*"}}), 1),
    "tiers-range": (_raw({"extra": {"activation_tiers": "full:0-5"}}), 1),
    "zero": (_raw(mesh={"data": 2, "fsdp": 2}, zero={"enabled": True, "stage": 2}), 4),
}


def _configs(raw: dict):
    try:
        jax_cfg = JaxRunConfig.model_validate(raw)
    except ValueError:
        jax_cfg = None
    try:
        port_cfg = RunConfig.model_validate(raw)
    except ValueError:
        port_cfg = None
    return jax_cfg, port_cfg


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_raises_where_jax_raises(case: str) -> None:
    raw, devices = PLAN_CASES[case]
    jax_cfg, port_cfg = _configs(raw)
    assert (jax_cfg is None) == (port_cfg is None)  # the schemas agree
    if jax_cfg is None:
        return
    try:
        want = jax_plan_from_config(jax_cfg, devices)
    except JaxMeshPlanError as exc:
        with pytest.raises(MeshPlanError) as got:
            plan_from_config(port_cfg, devices)
        assert str(got.value) == str(exc)
        return
    got = plan_from_config(port_cfg, devices)
    assert got.axes == want.axes
    for field in ("micro_batch_size", "grad_accum_steps", "remat", "zero_stage", "attention",
                  "activation_tiers"):
        assert getattr(got, field) == getattr(want, field), field
    # The trainer's batch degree and manifest topology of the plan.
    dp = data_parallel_degree(got.axes)
    assert dp == want.data_parallel
    assert describe_topology(
        mesh_axis_sizes(got.axes), data_parallel=dp, global_micro_batch=got.micro_batch_size * dp,
        micro_batch_size=got.micro_batch_size, grad_accum_steps=got.grad_accum_steps,
        num_processes=devices) == want.describe_topology(num_processes=devices)


def test_cli_exits_2_for_a_mesh_one_process_cannot_hold(tmp_path, capsys) -> None:
    from llmtrain_tpu_torch.cli import main as port_main

    for name, mesh, needle in (("moe", {"expert": 4, "data": 2}, "but 1 devices are available"),
                               ("pipe", {"data": 1, "pipeline": 2},
                                "but 1 devices are available")):
        raw = _raw({"extra": {"tokenizer": "byte"}}, mesh)
        raw["output"] = {"root_dir": str(tmp_path / "runs")}
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump(raw))
        assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", name]) == 2
        assert needle in capsys.readouterr().err


@pytest.mark.parametrize("sizes", [
    {"data": 2, "fsdp": 2, "tensor": 2}, {"data": 2, "tensor": 4}, {"data": 2, "sequence": 2,
                                                                    "expert": 2},
    {"data": 1, "fsdp": 2, "tensor": 2, "sequence": 2}])
def test_ranks_hold_the_coordinates_of_jax_devices(sizes) -> None:
    mesh = jax_build_mesh(JaxMeshConfig(**sizes), jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    full = {a: sizes.get(a, 1) for a in mesh.axis_names}
    for rank in range(8):
        coords = DeviceMesh(full, rank).coords
        assert ids[tuple(coords[a] for a in mesh.axis_names)] == rank


# --------------------------------------------------------------------------
# splits of every leaf, against JAX's NamedSharding
# --------------------------------------------------------------------------

TREES = {
    "gpt": {"name": "gpt", "vocab_size": 62},
    "gqa_llama": {"name": "llama", "extra": {"n_kv_heads": 2}},
    "gpt_moe": {"name": "gpt_moe", "extra": {"n_experts": 4}},
    "gpt_pipeline": {"name": "gpt_pipeline", "n_layers": 4, "extra": {"n_kv_heads": 2}},
}
MESHES = {
    "fsdp2-tensor2": {"data": 2, "fsdp": 2, "tensor": 2},
    "tensor4": {"data": 2, "tensor": 4},
    "sequence2-data2": {"data": 4, "sequence": 2},
    "expert4-data2": {"data": 2, "expert": 4},
    "pipeline4-data2": {"data": 2, "pipeline": 4},
    "pipeline2-tensor2-data2": {"data": 2, "tensor": 2, "pipeline": 2},
}


def _norm(spec, rank: int) -> tuple:
    """A JAX PartitionSpec as the port writes a spec: one entry per dim,
    None or a tuple of axis names."""
    entries = [None if a is None else ((a,) if isinstance(a, str) else tuple(a)) for a in spec]
    return tuple(entries + [None] * (rank - len(entries)))


def _jax_tree(name: str, sizes: dict):
    """JAX's abstract params of the tree (boxed with their logical names)
    and its mesh."""
    from llmtrain_tpu.registry import get_model_adapter, initialize_registries

    initialize_registries()
    raw = _raw({**TREES[name], "d_model": 32, "n_heads": 4, "d_ff": 64})
    raw["model"]["extra"] = {"tokenizer": "byte", **raw["model"].get("extra", {})}
    cfg = JaxRunConfig.model_validate(raw)
    adapter = get_model_adapter(cfg.model.name)()
    model = adapter.build_model(cfg)
    abstract = jax.eval_shape(lambda r: adapter.init_params(model, cfg, r), jax.random.key(0))
    mesh = jax_build_mesh(JaxMeshConfig(**sizes), jax.devices()[:8])
    return raw, abstract, mesh


def _port_leaves(raw: dict, *, names: dict | None = None
                 ) -> dict[str, tuple[tuple[int, ...], tuple | None]]:
    """Every port parameter as its flax leaf path: (flax shape, names);
    ``names`` receives each path's port parameter name."""
    from llmtrain_tpu_torch.models.lora import build_adapter
    from llmtrain_tpu_torch.registry import initialize_registries

    initialize_registries()
    cfg = RunConfig.model_validate(raw)
    model = build_adapter(cfg).build_model(cfg)
    named = dict(model.named_parameters())
    marks = {n: torch.full(p.shape, float(i)) for i, (n, p) in enumerate(named.items())}
    tree = state_dict_to_flax_params(marks, n_heads=cfg.model.n_heads,
                                     n_kv_heads=int(cfg.model.extra.get("n_kv_heads", 0)))
    order = list(named)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = order[int(v.reshape(-1)[0])]
                layout = param_layout(name, cfg.model.d_model // cfg.model.n_heads)
                shape = tuple(layout.to_flax(named[name].detach()).shape)
                assert shape == tuple(v.shape), name
                key = "/".join(path + (k,))
                out[key] = (shape, layout.names)
                if names is not None:
                    names[key] = name

    walk(tree, ())
    return out


def _jax_shardings(shardings) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): sh
            for path, sh in jax.tree_util.tree_flatten_with_path(
                shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))[0]}


def _jax_specs(shardings, abstract) -> dict[str, tuple]:
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[key] = sh
    shapes = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  nn_meta.unbox(abstract))[0]}
    return {k: _norm(sh.spec, len(shapes[k])) for k, sh in out.items()}


@pytest.mark.parametrize("tree,mesh", list(itertools.product(sorted(TREES), sorted(MESHES))))
def test_every_leaf_splits_as_jax(tree: str, mesh: str) -> None:
    sizes = MESHES[mesh]
    raw, abstract, jmesh = _jax_tree(tree, sizes)
    want = _jax_specs(jax_state_shardings(jmesh, abstract), abstract)
    leaves = _port_leaves(raw)
    full = {a: sizes.get(a, 1) for a in jmesh.axis_names}
    got = state_shardings(full, leaves)
    assert sorted(got) == sorted(want)
    for path, (shape, _) in leaves.items():
        assert _norm(got[path], len(shape)) == want[path], path


@pytest.mark.parametrize("tree,mesh", list(itertools.product(
    sorted(TREES), ["fsdp2-tensor2", "expert4-data2", "data8", "data2-fsdp2-sequence2",
                    "pipeline4-data2", "pipeline2-tensor2-data2"])))
def test_zero_partition_over_the_batch_axes_is_jax(tree: str, mesh: str) -> None:
    """Each rank's ZeRO slice of every parameter, as the trainer takes it
    (the rank's model and its layout on the mesh, ``ZeroPartition``, the
    optimizer's slices), holds the elements JAX's device of the same
    coordinates holds under ``opt_state_shardings``."""
    from llmtrain_tpu_torch.distributed.mesh import set_active_mesh
    from llmtrain_tpu_torch.models.lora import build_adapter
    from llmtrain_tpu_torch.parallel.mesh_params import model_layout
    from llmtrain_tpu_torch.parallel.zero import ZeroPartition
    from llmtrain_tpu_torch.training.optimizer import build_model_optimizer

    sizes = {"fsdp2-tensor2": {"data": 2, "fsdp": 2, "tensor": 2},
             "expert4-data2": {"data": 2, "expert": 4}, "data8": {"data": 8},
             "data2-fsdp2-sequence2": {"data": 2, "fsdp": 2, "sequence": 2},
             **MESHES}[mesh]
    raw, abstract, jmesh = _jax_tree(tree, sizes)
    want = _jax_shardings(jax_opt_state_shardings(jmesh, abstract, subject="gradient"))
    paths: dict[str, str] = {}
    leaves = _port_leaves(raw, names=paths)
    full = {a: sizes.get(a, 1) for a in jmesh.axis_names}
    cfg = RunConfig.model_validate(raw)
    adapter = build_adapter(cfg)
    head_dim = cfg.model.d_model // cfg.model.n_heads
    # Whole parameters whose flax leaves count 0, 1, 2, ...
    flax_wholes = {path: np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
                   for path, (shape, _) in leaves.items()}
    wholes = {name: param_layout(name, head_dim).from_flax(torch.from_numpy(flax_wholes[path]))
              for path, name in paths.items()}
    split = 0
    for rank in range(8):
        device = next(d for d in jmesh.devices.flat if d.id == rank)
        dmesh = DeviceMesh(full, rank)
        set_active_mesh(dmesh)
        try:
            model = adapter.build_model(cfg)
        finally:
            set_active_mesh(None)
        layout = model_layout(model, dmesh, head_dim)
        layout.load_whole(model, wholes)
        zero = ZeroPartition(stage=1, host_offload=False, layout=layout,
                             device=torch.device("cpu"))
        opt = build_model_optimizer(cfg, model, zero=zero)
        by_name = {n: (piece, d) for n, piece, d in zip(opt.names, opt.local, opt.split_dims)}
        for path, name in paths.items():
            piece, d = by_name[name]
            got = piece if d is not None else layout.leaves[name].layout.to_flax(piece)
            split += d is not None
            idx = want[path].devices_indices_map(flax_wholes[path].shape)[device]
            np.testing.assert_array_equal(got.detach().numpy(), flax_wholes[path][idx],
                                          err_msg=f"{path} on rank {rank}")
    assert split  # the case splits some leaf


def test_indivisible_leaf_is_stored_replicated_with_jax_warning(caplog) -> None:
    sizes = {"data": 1, "fsdp": 1, "tensor": 2, "sequence": 1, "pipeline": 1, "expert": 1}
    with caplog.at_level("WARNING", logger="llmtrain"):
        got = state_shardings(sizes, {"token_embedding/embedding": ((61, 32), ("vocab", "embed")),
                                      "tiny": ((1,), ("mlp",))})
    assert got == {"token_embedding/embedding": (), "tiny": ()}
    text = caplog.text
    assert "storing this leaf REPLICATED" in text and "token_embedding/embedding" in text
    assert "tiny" not in text


@pytest.mark.parametrize("sizes", [{"data": 8}, {"data": 2, "fsdp": 2, "tensor": 2},
                                   {"data": 2, "expert": 4}, {"data": 4, "sequence": 2},
                                   {"data": 1, "fsdp": 2, "sequence": 2, "expert": 2}])
def test_batch_layout_and_axis_sizes_are_jax(sizes) -> None:
    from llmtrain_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
    from llmtrain_tpu.parallel.sharding import data_parallel_degree as jax_dp
    from llmtrain_tpu.parallel.sharding import mesh_axis_sizes as jax_mesh_axis_sizes
    from llmtrain_tpu_torch.parallel.sharding import batch_sharding

    mesh = jax_build_mesh(JaxMeshConfig(**sizes), jax.devices()[:8])
    full = {a: sizes.get(a, 1) for a in mesh.axis_names}
    assert data_parallel_degree(full) == jax_dp(mesh)
    for accum in (False, True):
        got = batch_sharding(with_accum_dim=accum)
        want = jax_batch_sharding(mesh, with_accum_dim=accum).spec
        assert _norm(got, len(got)) == _norm(want, len(got))
    assert mesh_axis_sizes(full) == jax_mesh_axis_sizes(mesh)
