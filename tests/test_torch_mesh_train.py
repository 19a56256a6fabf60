"""The port's trainer on meshes with fsdp, tensor, sequence and expert
axes, as gloo ranks on the CPU, against the JAX trainer on the same mesh
over its 8 virtual CPU devices.

Each launch is one process group per world shape, several fits in it
(``CHILD``); rank 0 writes each fit's per-step losses, its stored
parameter bytes and the whole final parameters (gathered from every
rank). The JAX trainer runs in this process on the same mesh, its
``data`` axis filling the 8 devices, at the micro-batch that gives the
same global batch; the port starts from JAX's initial parameters.

* two ranks: GQA llama on ``{tensor: 2}``; ring, Ulysses and gathered
  ``flash`` attention on ``{sequence: 2}``; GPT with dropout 0.1 on
  ``{tensor: 2}`` against the port's own one-device run (the masks are
  drawn whole and sliced);
* four ranks: GPT on ``{fsdp: 2, tensor: 2}``; ``gpt_moe`` on
  ``{expert: 2, data: 2}``; ZeRO stage 1 on ``{data: 2, fsdp: 2}``, a
  rank's optimizer-state bytes JAX's per device on that mesh; the
  stored bytes of a rank are the split leaves' parts plus the replicated
  leaves (JAX's per-device parameter bytes); a checkpoint saved on
  ``{fsdp: 2, tensor: 2}`` resumes on ``{data: 2, tensor: 2}`` continuing
  the run, and on a mesh with another tensor degree exits 2.

Bands: the optimizer trajectory's, atol 3e-5 and rtol 1e-3, on the
per-step losses and the final parameters.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import yaml
from flax import serialization
from flax.linen import meta as nn_meta
from torch_port_helpers import port_env

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
STEPS = 6

CHILD = r"""
import json, os, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.distributed import setup_distributed, teardown_distributed
from llmtrain_tpu_torch.interop import flax_params_to_state_dict
from llmtrain_tpu_torch.resilience.exit_codes import exit_code_for_exception
from llmtrain_tpu_torch.training.train_step import make_loss_fn, reduce_on_mesh
from llmtrain_tpu_torch.training.trainer import Trainer

spec = json.loads(sys.argv[1])
out = Path(spec["out"])
rank = int(os.environ["RANK"])
losses = []
real_log = Trainer._log_train_interval

def log_interval(self, **kw):
    losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
    return real_log(self, **kw)

Trainer._log_train_interval = log_interval

def unflat(arrays):
    tree = {}
    for key, value in arrays.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree

def probe(trainer, run):
    # One micro-batch's gradients after the step's reduction, on this rank,
    # of the leaves named (gathered whole).
    batch = dict(np.load(run["probe"]))
    b = trainer._cfg.trainer.micro_batch_size
    rows = {k: torch.from_numpy(v[trainer._dp_index * b:(trainer._dp_index + 1) * b])
            for k, v in batch.items()}
    opt = trainer.state.optimizer
    loss_fn = make_loss_fn(trainer._adapter, trainer.model, use_dropout=False,
                           data_parallel=True, layout=trainer._layout)
    loss, _ = loss_fn(rows, None)
    loss.backward()
    grads, _ = reduce_on_mesh(trainer._layout, opt, [p.grad for p in opt.params],
                              loss.detach()[None])
    for p in opt.params:
        p.grad = None
    np.savez(out / f"{run['name']}_grads_{rank}.npz",
             **{n: trainer._layout.whole(n, g).numpy() for n, g in zip(opt.names, grads)
                if n in run["probe_leaves"]})

setup_distributed(RunConfig.model_validate(spec["runs"][0]["raw"]).distributed, "cpu")
summary = {}
for run in spec["runs"]:
    losses.clear()
    cfg = RunConfig.model_validate(run["raw"])
    run_dir = Path(run["run_dir"]) if run.get("run_dir") else None
    if run_dir is not None:
        run_dir.mkdir(parents=True, exist_ok=True)
    try:
        trainer = Trainer(cfg, run_dir)
        if run.get("init"):
            whole = flax_params_to_state_dict(unflat(dict(np.load(run["init"]))))
            if trainer._layout is not None:
                trainer._layout.load_whole(trainer.model, whole)
            else:
                trainer.model.load_state_dict(whole)
        if run.get("probe"):
            probe(trainer, run)
        trainer.fit(run["steps"], resume_from=run.get("resume"))
    except Exception as exc:
        if not run.get("expect_error"):
            raise
        summary[run["name"]] = {"exit_code": exit_code_for_exception(exc), "error": str(exc)}
        continue
    layout = trainer._layout
    model = trainer.model
    whole = layout.whole_state_dict(model) if layout is not None else model.state_dict()
    stored = sum(p.numel() * p.element_size() for p in model.parameters())
    opt_bytes = trainer._opt_state_memory()["opt_state_bytes_per_device"]
    val = trainer._evaluate(run["steps"], run["steps"])["val/loss"] if run.get("val") else None
    if rank == 0:
        np.savez(out / f"{run['name']}.npz", **{k: v.detach().numpy() for k, v in whole.items()})
        summary[run["name"]] = {"losses": list(losses), "stored_bytes": stored,
                                "opt_bytes": opt_bytes, "val": val,
                                "param_count": trainer._param_count}
if rank == 0:
    (out / "summary.json").write_text(json.dumps(summary))
torch.distributed.barrier()  # no rank leaves while another still holds the group
teardown_distributed()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path, runs: list[dict], world: int) -> dict:
    """The ``runs`` as ``world`` gloo ranks; rank 0's summary and arrays."""
    out = tmp / f"out{world}"
    out.mkdir()
    spec = json.dumps({"out": str(out), "runs": runs})
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, spec], cwd=tmp,
        env=port_env(RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=400))
    finally:
        for proc in procs:  # a rank left in a collective must not outlive the test
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-6000:]
    summary = json.loads((out / "summary.json").read_text())
    for name, entry in summary.items():
        if "losses" in entry:
            entry["params"] = dict(np.load(out / f"{name}.npz"))
        entry["grads"] = [dict(np.load(g)) for g in sorted(out.glob(f"{name}_grads_*.npz"))]
    return summary


def _raw(model: dict, mesh: dict, *, micro: int = 4, zero: dict | None = None,
         dropout: float = 0.0, extra: dict | None = None) -> dict:
    trainer = {"max_steps": 128, "micro_batch_size": micro, "grad_accum_steps": 2,
               "lr": 0.003, "weight_decay": 0.01, "warmup_steps": 2, "max_grad_norm": 0.5,
               "log_every_steps": 1, "eval_every_steps": 1000, "save_every_steps": 3}
    if zero is not None:
        trainer["zero"] = {"enabled": True, **zero}
    return {
        "schema_version": 1,
        "run": {"name": "mesh", "seed": 5, "device": "cpu", "deterministic": True},
        "model": {"block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 4,
                  "d_ff": 64, "vocab_size": 64, "dropout": dropout, **model,
                  "extra": {"tokenizer": "byte", **model.get("extra", {}), **(extra or {})}},
        "data": {"name": "dummy_text"},
        "trainer": trainer,
        "distributed": {"enabled": True, "timeout_sec": 120, "mesh": {"data": 1, **mesh}},
        "telemetry": {"enabled": False},
        "mlflow": {"enabled": False},
    }


GPT = {"name": "gpt", "attention": "dense"}
LLAMA_GQA = {"name": "llama", "attention": "dense", "extra": {"n_kv_heads": 2}}
MOE = {"name": "gpt_moe", "attention": "dense",
       "extra": {"n_experts": 4, "capacity_factor": 1.0, "router_top_k": 2}}


def _jax_mesh(mesh: dict) -> dict:
    """The port's mesh with its data axis widened to fill 8 devices."""
    rest = math.prod(v for k, v in mesh.items() if k != "data")
    return {**mesh, "data": 8 // rest}


def _dp(mesh: dict) -> int:
    return mesh.get("data", 1) * mesh.get("fsdp", 1) * mesh.get("expert", 1)


def _jax_fit(raw: dict, tmp: Path, steps: int = STEPS, *, with_val: bool = False) -> dict:
    """JAX's trainer on the port's mesh (data widened) at the same global
    batch: its initial params (as an npz of flat flax paths), per-step
    losses, final params and per-device parameter bytes (``with_val``:
    and the val loss after the fit)."""
    from unittest import mock

    from llmtrain_tpu.config import load_and_validate_config
    from llmtrain_tpu.registry import initialize_registries
    from llmtrain_tpu.tracking.base import NullTracker
    from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
    from llmtrain_tpu_torch.interop import flax_params_to_state_dict

    mesh = raw["distributed"]["mesh"]
    jmesh = _jax_mesh(mesh)
    micro = raw["trainer"]["micro_batch_size"] * _dp(mesh) // _dp(jmesh)
    jraw = {**raw, "trainer": {**raw["trainer"], "micro_batch_size": micro},
            "distributed": {"enabled": False, "mesh": jmesh}}
    path = tmp / f"jax_{len(list(tmp.glob('jax_*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(jraw, sort_keys=False))
    initialize_registries()
    trainer = JaxTrainer(load_and_validate_config(path)[0], None, NullTracker())
    init = jax.device_get(serialization.to_state_dict(nn_meta.unbox(trainer._state.params)))
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(init)
    init_path = path.with_suffix(".npz")
    np.savez(init_path, **flat)
    per_device = sum(leaf.addressable_shards[0].data.nbytes
                     for leaf in jax.tree_util.tree_leaves(nn_meta.unbox(trainer._state.params)))
    opt_bytes = _jax_opt_bytes(trainer, mesh) if raw["trainer"].get("zero") else None
    losses: list[float] = []
    original = JaxTrainer._log_train_interval

    def log_interval(self, **kw):
        losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
        return original(self, **kw)

    with mock.patch.object(JaxTrainer, "_log_train_interval", log_interval):
        trainer.fit(steps)
    final = jax.device_get(serialization.to_state_dict(nn_meta.unbox(trainer._state.params)))
    val = trainer._evaluate(steps, steps)["val/loss"] if with_val else None
    return {"init": str(init_path), "losses": losses, "per_device": per_device,
            "opt_bytes": opt_bytes, "val": val,
            "params": {k: v.numpy() for k, v in flax_params_to_state_dict(final).items()}}


def _jax_opt_bytes(trainer, mesh: dict) -> int:
    """JAX's optimizer-state bytes on the first device of the port's own
    mesh (``opt_state_shardings`` over the trainer's abstract state on as
    many devices as the port has ranks), its moments only: optax's scalar
    step counts have no counterpart on the port's device."""
    from llmtrain_tpu.config.schemas import MeshConfig as JaxMeshConfig
    from llmtrain_tpu.distributed import build_mesh as jax_build_mesh
    from llmtrain_tpu.parallel.sharding import opt_state_shardings

    world = math.prod(mesh.values())
    jmesh = jax_build_mesh(JaxMeshConfig(**mesh), jax.devices()[:world])
    abstract = jax.eval_shape(
        lambda r: trainer._tx.init(trainer._adapter.init_params(trainer._model, trainer._cfg, r)),
        jax.random.key(0))
    shardings = opt_state_shardings(jmesh, abstract)
    total = 0
    for sh, leaf in zip(jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)),
            jax.tree_util.tree_leaves(nn_meta.unbox(abstract))):
        if leaf.ndim:
            total += math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
    return total


def _assert_tracks(port: dict, ref: dict) -> None:
    assert len(port["losses"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    assert sorted(port["params"]) == sorted(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(port["params"][k], v, atol=TRAJ_ATOL, rtol=TRAJ_RTOL,
                                   err_msg=k)


def test_two_rank_meshes_track_jax(tmp_path) -> None:
    """GQA llama on {tensor: 2}; ring, Ulysses and gathered flash on
    {sequence: 2}; dropout on {tensor: 2} against the one-device run."""
    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.training.trainer import Trainer

    cases = {
        "llama_tensor": _raw(LLAMA_GQA, {"tensor": 2}),
        "ring": _raw({**GPT, "attention": "ring"}, {"sequence": 2}),
        "ulysses": _raw({**GPT, "attention": "ulysses"}, {"sequence": 2}),
        "flash_sequence": _raw({**GPT, "attention": "flash"}, {"sequence": 2}),
    }
    refs = {name: _jax_fit(raw, tmp_path) for name, raw in cases.items()}
    dropout = _raw(GPT, {"tensor": 2}, dropout=0.1)
    runs = [dict(name=n, raw=raw, steps=STEPS, init=refs[n]["init"]) for n, raw in cases.items()]
    runs.append(dict(name="dropout", raw=dropout, steps=STEPS))
    got = _launch(tmp_path, runs, world=2)
    for name in cases:
        _assert_tracks(got[name], refs[name])
    # Heads, the mlp dim and the vocabulary split over tensor: a rank
    # stores JAX's per-device parameter bytes.
    assert got["llama_tensor"]["stored_bytes"] == refs["llama_tensor"]["per_device"]
    # The port's one-device run of the dropout config (no process group).
    one_raw = {**dropout, "distributed": {"enabled": False}}
    one = Trainer(RunConfig.model_validate(one_raw), None)
    losses: list[float] = []
    real = Trainer._log_train_interval

    def log_interval(self, **kw):
        losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
        return real(self, **kw)

    Trainer._log_train_interval = log_interval
    try:
        one.fit(STEPS)
    finally:
        Trainer._log_train_interval = real
    ref = {"losses": losses,
           "params": {k: v.detach().numpy() for k, v in one.model.state_dict().items()}}
    _assert_tracks(got["dropout"], ref)


def test_four_rank_meshes_track_jax(tmp_path) -> None:
    """GPT on {fsdp: 2, tensor: 2}, gpt_moe on {expert: 2, data: 2}, ZeRO
    stage 1 on {data: 2, fsdp: 2}; a rank's stored bytes; a checkpoint of
    the first resumed on {data: 2, tensor: 2} and, refused, on a mesh
    with another tensor degree."""
    cases = {
        "fsdp_tensor": _raw(GPT, {"fsdp": 2, "tensor": 2}),
        "moe_expert": _raw(MOE, {"expert": 2, "data": 2}),
        "zero_data_fsdp": _raw(GPT, {"data": 2, "fsdp": 2}, zero={"stage": 1}),
    }
    refs = {name: _jax_fit(raw, tmp_path) for name, raw in cases.items()}
    ckpt = tmp_path / "ckpt_fsdp_tensor"
    saved = ckpt / "checkpoints" / "step_000003.ckpt"
    runs = [dict(name=n, raw=raw, steps=STEPS, init=refs[n]["init"]) for n, raw in cases.items()]
    runs[0]["run_dir"] = str(ckpt)
    runs += [
        dict(name="resumed", raw=_raw(GPT, {"data": 2, "tensor": 2}), steps=STEPS,
             resume=str(saved)),
        dict(name="tensor_changed", raw=_raw(GPT, {"data": 2, "fsdp": 2}), steps=STEPS,
             resume=str(saved), expect_error=True),
    ]
    got = _launch(tmp_path, runs, world=4)
    for name in cases:
        _assert_tracks(got[name], refs[name])
    for name in ("fsdp_tensor", "moe_expert"):
        assert got[name]["stored_bytes"] == refs[name]["per_device"], name
    # ZeRO's moments on a rank: JAX's per-device optimizer-state bytes on
    # the same mesh.
    assert got["zero_data_fsdp"]["opt_bytes"] == refs["zero_data_fsdp"]["opt_bytes"]
    # Elastic over fsdp -> data: steps 4..6 continue the saved run's.
    np.testing.assert_allclose(got["resumed"]["losses"], got["fsdp_tensor"]["losses"][3:],
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    for k, v in got["fsdp_tensor"]["params"].items():
        np.testing.assert_allclose(got["resumed"]["params"][k], v, atol=TRAJ_ATOL,
                                   rtol=TRAJ_RTOL, err_msg=k)
    refused = got["tensor_changed"]
    assert refused["exit_code"] == 2 and "tensor" in refused["error"], refused
