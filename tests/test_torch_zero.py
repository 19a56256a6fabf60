"""ZeRO in the port (``trainer.zero``; llmtrain_tpu_torch/parallel/) on the CPU.

* The partition rule against JAX's ``opt_state_shardings`` on the same
  leaf shapes and data-parallel degree (the cases of tests/test_zero.py's
  ``TestOptStateShardings``), its one-time warning, the silent ``(1,)``
  placeholder, and ``host_memory_kind`` on the CPU.
* Two gloo ranks of the port's trainer, several fits in one process
  group per rank (``CHILD``): stage 1 and stage 1 with host offload
  bitwise equal to the replicated run (losses, final params and the
  gathered optimizer state), also through a NaN window under the
  non-finite guard; stage 2 within the optimizer band; Adafactor (stage
  1; stage 2 in the band), and Lion with the EMA, bitwise under ZeRO;
  per-device state bytes are the split leaves' halves plus the
  replicated leaves.
* Checkpoints hold whole arrays: a 2-rank ZeRO checkpoint resumes at one
  rank without ZeRO exactly as the replicated run's checkpoint does, and
  a one-rank checkpoint resumes at two ranks under ZeRO exactly as
  without.

The model has d_model 63 and 3 heads, so some leaves have no even dim
(qkv, out_proj, the norms: replicated, with the warning), others split
along dim 0 and some along dim 1 (``mlp_proj``, (63, 128)).
Band (stage 2): the optimizer trajectory's, atol 3e-5 and rtol 1e-3.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import port_env

from llmtrain_tpu.config import MeshConfig
from llmtrain_tpu.distributed import build_mesh
from llmtrain_tpu.parallel.sharding import opt_state_shardings as jax_opt_state_shardings
from llmtrain_tpu_torch.parallel.sharding import (
    host_memory_kind,
    zero_partition_dim,
)

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
STEPS = 8

# Each rank: one process group, then the fits of the spec in order;
# rank 0 writes each fit's per-step losses, optimizer bytes, final params
# and gathered optimizer state.
CHILD = r"""
import json, os, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.distributed import setup_distributed, teardown_distributed
from llmtrain_tpu_torch.training.trainer import Trainer

spec = json.loads(sys.argv[1])
out = Path(spec["out"])
rank = int(os.environ.get("RANK", "0"))
losses = []
real_log = Trainer._log_train_interval

def log_interval(self, **kw):
    losses.extend(float(x) for x in np.asarray(kw["losses_host"]))
    return real_log(self, **kw)

Trainer._log_train_interval = log_interval

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)

setup_distributed(RunConfig.model_validate(spec["runs"][0]["raw"]).distributed, "cpu")
summary = {}
for run in spec["runs"]:
    losses.clear()
    cfg = RunConfig.model_validate(run["raw"])
    run_dir = None
    if run.get("run_dir"):
        run_dir = Path(run["run_dir"])
        run_dir.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(cfg, run_dir)
    trainer.fit(run["steps"], resume_from=run.get("resume"))
    opt = trainer.state.optimizer
    state = dict(flat(opt.state_dict()))
    memory = opt.memory()
    if rank == 0:
        params = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
        np.savez(out / f"{run['name']}.npz", **{f"p:{k}": v for k, v in params.items()},
                 **{f"s:{k}": v for k, v in state.items()})
        summary[run["name"]] = {"losses": list(losses), "memory": memory}
if rank == 0:
    (out / "summary.json").write_text(json.dumps(summary))
teardown_distributed()
"""


@pytest.fixture(autouse=True)
def _thread_cap():
    import torch

    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the partition rule, against JAX's
# --------------------------------------------------------------------------

RULE_CASES = [
    ((8, 6), 4),
    ((8, 16), 2),
    ((6, 8), 4),  # the first dim is indivisible: the second takes the split
    ((5, 3), 4),  # no divisible dim: replicated
    ((), 4),  # a scalar (Adam's count)
    ((1,), 4),  # Adafactor's placeholder
    ((3, 5, 8), 2),
    ((8, 8), 1),  # one device: the identity
]


def shard_shape(shape: tuple[int, ...], dim: int | None, world: int) -> tuple[int, ...]:
    """One rank's part of a leaf of ``shape`` split along ``dim``."""
    return tuple(n // world if i == dim else n for i, n in enumerate(shape))


@pytest.mark.parametrize("shape,world", RULE_CASES)
def test_partition_rule_matches_jax(shape, world) -> None:
    mesh = build_mesh(MeshConfig(data=world), jax.devices("cpu")[:world])
    jax_sh = jax_opt_state_shardings(mesh, {"leaf": jax.ShapeDtypeStruct(shape, jnp.float32)})
    want = tuple(jax_sh["leaf"].shard_shape(shape))
    dim = zero_partition_dim(shape, world)
    assert shard_shape(shape, dim, world) == want


def _warnings(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING]


def test_indivisible_leaf_warns_once_naming_it(caplog) -> None:
    caplog.set_level(logging.WARNING, logger="llmtrain")
    logger = logging.getLogger("llmtrain")
    propagate, logger.propagate = logger.propagate, True
    try:
        for _ in range(2):
            assert zero_partition_dim((5, 3), 4, name="odd_leaf_once") is None
    finally:
        logger.propagate = propagate
    hits = [m for m in _warnings(caplog) if "ZeRO" in m and "odd_leaf_once" in m]
    assert len(hits) == 1 and "REPLICATED" in hits[0]


def test_placeholder_and_scalar_stay_silent(caplog) -> None:
    caplog.set_level(logging.WARNING, logger="llmtrain")
    logger = logging.getLogger("llmtrain")
    propagate, logger.propagate = logger.propagate, True
    try:
        assert zero_partition_dim((1,), 4, name="ph_silent") is None
        assert zero_partition_dim((), 4, name="count_silent") is None
    finally:
        logger.propagate = propagate
    assert not any("ph_silent" in m or "count_silent" in m for m in _warnings(caplog))


def test_no_pinned_host_memory_on_cpu() -> None:
    assert host_memory_kind("cpu") is None  # the round trip on the CPU


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(*, micro: int = 4, zero: dict | None = None, extra: dict | None = None,
         resilience: dict | None = None) -> dict:
    trainer = {
        "max_steps": 32, "micro_batch_size": micro, "grad_accum_steps": 2, "lr": 0.003,
        "weight_decay": 0.01, "warmup_steps": 2, "max_grad_norm": 0.5,
        "log_every_steps": 1, "eval_every_steps": 1000, "save_every_steps": 4,
        "extra": extra or {},
    }
    if zero is not None:
        trainer["zero"] = {"enabled": True, **zero}
    raw = {
        "schema_version": 1,
        "run": {"name": "zero", "seed": 123, "device": "cpu", "deterministic": True},
        "model": {"name": "gpt", "block_size": 8, "d_model": 63, "n_layers": 2, "n_heads": 3,
                  "d_ff": 128, "dropout": 0.0, "vocab_size": 64},
        "data": {"name": "dummy_text"},
        "trainer": trainer,
        "distributed": {"enabled": True, "timeout_sec": 60},
        "telemetry": {"enabled": False},
        "mlflow": {"enabled": False},
    }
    if resilience:
        raw["resilience"] = resilience
    return raw


def _launch(tmp: Path, name: str, runs: list[dict], world: int) -> dict:
    """The ``runs`` as ``world`` gloo ranks; rank 0's summary and arrays."""
    out = tmp / name
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
            outs.append(proc.communicate(timeout=240))
    finally:
        for proc in procs:  # a rank left in a collective must not outlive the test
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-4000:]
    summary = json.loads((out / "summary.json").read_text())
    return {name: dict(summary[name], arrays=dict(np.load(out / f"{name}.npz")))
            for name in summary}


def _bitwise(a: dict, b: dict) -> None:
    assert a["losses"] == b["losses"]
    assert sorted(a["arrays"]) == sorted(b["arrays"])
    for k in a["arrays"]:
        np.testing.assert_array_equal(a["arrays"][k], b["arrays"][k], err_msg=k)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory) -> dict:
    """Every 2-rank fit of this file, in one launch (the checkpoint runs
    and the one-rank and second 2-rank launches follow in
    :func:`resumes`)."""
    tmp = tmp_path_factory.mktemp("zero2")
    nan = {"nonfinite_guard": True, "faults": {"nan_loss_at_step": 3}}
    runs = [
        dict(name="plain", raw=_raw(), steps=STEPS, run_dir=str(tmp / "ckpt_plain")),
        dict(name="stage1", raw=_raw(zero={"stage": 1}), steps=STEPS,
             run_dir=str(tmp / "ckpt_stage1")),
        dict(name="offload", raw=_raw(zero={"stage": 1, "host_offload": True}), steps=STEPS),
        dict(name="stage2", raw=_raw(zero={"stage": 2}), steps=STEPS),
        dict(name="plain_nan", raw=_raw(resilience=nan), steps=STEPS),
        dict(name="stage1_nan", raw=_raw(zero={"stage": 1}, resilience=nan), steps=STEPS),
        dict(name="stage2_nan", raw=_raw(zero={"stage": 2}, resilience=nan), steps=STEPS),
        dict(name="adafactor", raw=_raw(extra={"optimizer": "adafactor"}), steps=STEPS),
        dict(name="adafactor_zero", raw=_raw(zero={"stage": 1},
                                             extra={"optimizer": "adafactor"}), steps=STEPS),
        dict(name="adafactor_zero2", raw=_raw(zero={"stage": 2},
                                              extra={"optimizer": "adafactor"}), steps=STEPS),
        dict(name="lion_ema", raw=_raw(extra={"optimizer": "lion", "ema_decay": 0.9}),
             steps=STEPS),
        dict(name="lion_ema_zero", raw=_raw(zero={"stage": 1, "host_offload": True},
                                            extra={"optimizer": "lion", "ema_decay": 0.9}),
             steps=STEPS),
        # ZeRO on from a checkpoint written without it, at the same world size.
        dict(name="stage1_from_plain", raw=_raw(zero={"stage": 1}), steps=STEPS,
             resume=str(tmp / "ckpt_plain" / "checkpoints" / "step_000004.ckpt")),
    ]
    return dict(tmp=tmp, fits=_launch(tmp, "two", runs, world=2))


def test_stage1_and_host_offload_are_bitwise_the_replicated_run(two_ranks) -> None:
    fits = two_ranks["fits"]
    assert len(fits["plain"]["losses"]) == STEPS
    _bitwise(fits["stage1"], fits["plain"])
    _bitwise(fits["offload"], fits["plain"])


def test_guard_skips_the_nan_step_alike_under_zero(two_ranks) -> None:
    fits = two_ranks["fits"]
    assert not np.isfinite(fits["plain_nan"]["losses"][2])
    _bitwise(fits["stage1_nan"], fits["plain_nan"])
    got, want = fits["stage2_nan"], fits["plain_nan"]
    np.testing.assert_allclose(np.delete(got["losses"], 2), np.delete(want["losses"], 2),
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)


def test_stage2_stays_in_the_optimizer_band(two_ranks) -> None:
    got, want = two_ranks["fits"]["stage2"], two_ranks["fits"]["plain"]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    for k, v in want["arrays"].items():
        if k.startswith("p:"):
            np.testing.assert_allclose(got["arrays"][k], v, atol=TRAJ_ATOL, rtol=TRAJ_RTOL,
                                       err_msg=k)


def test_adafactor_lion_and_the_ema_under_zero(two_ranks) -> None:
    fits = two_ranks["fits"]
    _bitwise(fits["adafactor_zero"], fits["adafactor"])
    np.testing.assert_allclose(fits["adafactor_zero2"]["losses"], fits["adafactor"]["losses"],
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    _bitwise(fits["lion_ema_zero"], fits["lion_ema"])
    assert any(k.startswith("s:__param_ema__/") for k in fits["lion_ema_zero"]["arrays"])


def test_per_device_bytes_are_the_split_halves_plus_the_replicated(two_ranks) -> None:
    fits = two_ranks["fits"]
    params = {k[2:]: v for k, v in fits["plain"]["arrays"].items() if k.startswith("p:")}
    whole = sum(2 * v.nbytes for v in params.values())  # mu and nu
    local = sum(2 * (v.nbytes // 2 if zero_partition_dim(v.shape, 2) is not None else v.nbytes)
                for v in params.values())
    assert fits["plain"]["memory"] == {"opt_state_bytes": whole,
                                       "opt_state_bytes_per_device": whole,
                                       "opt_state_bytes_host": 0}
    assert fits["stage1"]["memory"] == {"opt_state_bytes": whole,
                                        "opt_state_bytes_per_device": local,
                                        "opt_state_bytes_host": 0}
    assert whole / 2 < local < whole
    assert fits["offload"]["memory"] == {"opt_state_bytes": whole,
                                         "opt_state_bytes_per_device": 0,
                                         "opt_state_bytes_host": whole}


def test_checkpoints_hold_whole_arrays_and_resume_zero_on_from_off(two_ranks) -> None:
    tmp, fits = two_ranks["tmp"], two_ranks["fits"]
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    for step in (4, 8):
        name = f"step_{step:06d}.ckpt"
        a = CheckpointManager.load(tmp / "ckpt_stage1" / "checkpoints" / name)
        b = CheckpointManager.load(tmp / "ckpt_plain" / "checkpoints" / name)
        for part in ("params", "opt_state"):
            la, lb = jax.tree_util.tree_leaves(a[part]), jax.tree_util.tree_leaves(b[part])
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    resumed, plain = fits["stage1_from_plain"], fits["plain"]
    assert resumed["losses"] == plain["losses"][4:]
    for k, v in plain["arrays"].items():
        np.testing.assert_array_equal(resumed["arrays"][k], v, err_msg=k)


def test_checkpoints_resume_across_world_sizes_and_zero(two_ranks) -> None:
    """A 2-rank ZeRO checkpoint at one rank without ZeRO (micro batch 8:
    the same global batches) gives the bits the replicated run's
    checkpoint gives; then that one-rank run's checkpoint at two ranks
    under ZeRO gives the bits it gives without."""
    tmp = two_ranks["tmp"]
    ckpt = "checkpoints/step_000004.ckpt"
    one = _launch(tmp, "one", [
        dict(name="from_zero", raw=_raw(micro=8), steps=STEPS,
             resume=str(tmp / "ckpt_stage1" / ckpt), run_dir=str(tmp / "ckpt_one")),
        dict(name="from_plain", raw=_raw(micro=8), steps=STEPS,
             resume=str(tmp / "ckpt_plain" / ckpt)),
    ], world=1)
    _bitwise(one["from_zero"], one["from_plain"])
    np.testing.assert_allclose(one["from_zero"]["losses"],
                               two_ranks["fits"]["plain"]["losses"][4:],
                               atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    back = _launch(tmp, "back", [
        dict(name="zero", raw=_raw(zero={"stage": 1, "host_offload": True}), steps=10,
             resume=str(tmp / "ckpt_one" / "checkpoints" / "step_000008.ckpt")),
        dict(name="plain", raw=_raw(), steps=10,
             resume=str(tmp / "ckpt_one" / "checkpoints" / "step_000008.ckpt")),
    ], world=2)
    assert len(back["zero"]["losses"]) == 2
    _bitwise(back["zero"], back["plain"])
