"""The port's multi-process runtime (``llmtrain_tpu_torch/distributed``)
against the JAX package's, on the CPU: topology resolution over the env
and config cases of ``tests/test_distributed.py``, the one-process setup
and teardown, the fail-fast errors, and the collectives, the identity on
one process and right on a spawned two-rank gloo group (each child with
its own timeout).
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys

import pytest
import torch
from torch_port_helpers import port_env

from llmtrain_tpu.config import DistributedConfig as JaxDistributedConfig
from llmtrain_tpu.distributed import resolve_topology as jax_resolve_topology
from llmtrain_tpu_torch.config.schemas import DistributedConfig
from llmtrain_tpu_torch.distributed import (
    DistState,
    active_state,
    allgather_any,
    allgather_scalar,
    barrier,
    broadcast_int_from_main,
    resolve_topology,
    setup_distributed,
    teardown_distributed,
)

_ENV_NAMES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "JAX_PROCESS_ID",
              "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS", "LOCAL_RANK")

# tests/test_distributed.py::TestTopologyResolution, case by case.
TOPOLOGY_CASES = {
    "env-beats-config": ({"RANK": "1", "WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.1",
                          "MASTER_PORT": "12345"},
                         dict(process_id=0, num_processes=2, coordinator_addr="cfg-host")),
    "jax-native-env-beats-torch-names": ({"RANK": "1", "JAX_PROCESS_ID": "2",
                                          "JAX_NUM_PROCESSES": "8",
                                          "JAX_COORDINATOR_ADDRESS": "coord:1234"}, {}),
    "config-fallback": ({}, dict(process_id=1, num_processes=2, coordinator_addr="host",
                                 coordinator_port=999)),
    "defaults": ({}, {}),
    "bad-env-int": ({"WORLD_SIZE": "banana"}, {}),
    "multiprocess-unset-process-id": ({"WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.1"}, {}),
    "empty-coordinator-env-falls-back": ({"JAX_COORDINATOR_ADDRESS": "",
                                          "MASTER_ADDR": "10.0.0.2"}, {}),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in _ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    yield
    teardown_distributed()


def _answer(fn, cfg):
    try:
        return fn(cfg)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("case", list(TOPOLOGY_CASES))
def test_resolve_topology_matches_jax(monkeypatch, case) -> None:
    env, cfg = TOPOLOGY_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = _answer(resolve_topology, DistributedConfig(**cfg))
    assert ours == _answer(jax_resolve_topology, JaxDistributedConfig(**cfg))
    if case in ("bad-env-int", "multiprocess-unset-process-id"):
        assert ours[0] == "ValueError"


def test_dist_state_invariants() -> None:
    s = DistState(process_index=0, num_processes=2, local_device_count=1, is_main=True)
    assert (s.rank, s.world_size) == (0, 2)
    for kw in (dict(process_index=1, num_processes=2, is_main=True),
               dict(process_index=2, num_processes=2, is_main=False),
               dict(process_index=0, num_processes=0, is_main=True)):
        with pytest.raises(ValueError):
            DistState(local_device_count=1, **kw)


def test_one_process_setup_is_idempotent_and_tears_down() -> None:
    import torch.distributed as dist

    state = setup_distributed(DistributedConfig(), "cpu")
    assert (state.num_processes, state.process_index, state.is_main) == (1, 0, True)
    assert state.backend == "gloo" and dist.get_backend() == "gloo"
    assert active_state() is state
    assert setup_distributed(DistributedConfig(), "cpu") is state
    # One rank: the collectives are the identity, through the group.
    assert allgather_any(True) is True and allgather_any(False) is False
    assert allgather_scalar(2.5) == [2.5]
    assert broadcast_int_from_main(7) == 7
    teardown_distributed()
    assert active_state() is None and not dist.is_initialized()
    teardown_distributed()  # a second teardown is a no-op


def test_collectives_without_a_group_are_the_identity() -> None:
    assert allgather_any(True) is True and allgather_any(False) is False
    assert allgather_scalar(1.25) == [1.25]
    assert broadcast_int_from_main(3) == 3
    barrier()


def test_multi_process_without_a_coordinator_raises() -> None:
    with pytest.raises(ValueError, match="coordinator"):
        setup_distributed(DistributedConfig(num_processes=2, process_id=0), "cpu")
    assert active_state() is None


def test_no_card_raises_for_the_card(monkeypatch) -> None:
    """run.device cuda with no card visible raises: no fallback to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        setup_distributed(DistributedConfig(), "cuda")
    assert active_state() is None


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


_CHILD = """
import json, sys, torch
from llmtrain_tpu_torch.config.schemas import DistributedConfig
from llmtrain_tpu_torch.distributed import (
    allgather_any, allgather_scalar, barrier, broadcast_int_from_main, setup_distributed,
    teardown_distributed)
from llmtrain_tpu_torch.training.train_step import all_reduce_coalesced

state = setup_distributed(DistributedConfig(timeout_sec=60), "cpu")
r = state.process_index
out = {
    "rank": r, "world": state.num_processes, "backend": state.backend,
    "any_one": allgather_any(r == 1), "any_none": allgather_any(False),
    "scalars": allgather_scalar(1.5 * r + 0.25),
    "main_int": broadcast_int_from_main(10 + r),
}
barrier()
summed = all_reduce_coalesced([torch.full((3,), float(r + 1)), torch.arange(4.0) * (r + 1),
                               torch.full((2,), r + 1, dtype=torch.float64)])
out["summed"] = [t.tolist() for t in summed]
teardown_distributed()
print(json.dumps(out))
"""


def launch(code: str, world: int, timeout: float = 120, extra_env: dict | None = None,
           args: tuple[str, ...] = ()) -> list[tuple[int, str, str]]:
    """``world`` Python children running ``code`` as ranks 0..world-1 of a
    gloo group on a free local port; (exit code, stdout, stderr) each."""
    port = str(free_port())
    procs = []
    for rank in range(world):
        env = port_env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def test_collectives_on_two_gloo_ranks() -> None:
    outs = launch(_CHILD, 2, timeout=120)
    results = []
    for code, out, err in outs:
        assert code == 0, err[-2000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    for r, res in enumerate(results):
        assert (res["rank"], res["world"], res["backend"]) == (r, 2, "gloo")
        assert res["any_one"] is True and res["any_none"] is False
        assert res["scalars"] == [0.25, 1.75]
        assert res["main_int"] == 10
        assert res["summed"] == [[3.0] * 3, [0.0, 3.0, 6.0, 9.0], [3.0, 3.0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_the_nccl_gradient_op_sums_as_gloo_does(dtype) -> None:
    """Gloo reduces the gradients with SUM, NCCL with a sum pre-multiplied
    by its factor. The factor is exactly 1.0, so the NCCL op's sums
    (each rank's buffer times the factor, then summed) are bit-identical
    to SUM's on the same per-rank buffers."""
    import torch.distributed as dist

    from llmtrain_tpu_torch.training.train_step import grad_reduce_op

    assert grad_reduce_op("gloo") == dist.ReduceOp.SUM
    nccl = grad_reduce_op("nccl")
    assert nccl.op == dist.ReduceOp.PREMUL_SUM and nccl.factor == 1.0
    gen = torch.Generator().manual_seed(0)
    ranks = [torch.randn(4096, generator=gen, dtype=torch.float64).mul(10.0 ** r).to(dtype)
             for r in range(-3, 4)]
    summed = ranks[0].clone()
    premul = (ranks[0] * nccl.factor).to(dtype)
    for buf in ranks[1:]:
        summed += buf
        premul += (buf * nccl.factor).to(dtype)
    assert torch.equal(premul, summed)


@pytest.mark.parametrize(
    "mesh,world,refused",
    [({"data": -1}, 2, False), ({"data": 2}, 2, False), ({"data": 1}, 1, False),
     ({"data": 3}, 2, True), ({"data": 1}, 2, True), ({"data": -1, "tensor": 2}, 2, False),
     ({"data": 1, "fsdp": -1}, 1, False)],
    ids=["wildcard", "process-count", "one", "other-size", "one-of-two", "tensor-axis",
         "wildcard-elsewhere-one-process"],
)
def test_the_data_axis_is_the_process_count(mesh, world, refused) -> None:
    """The mesh's axes tile the processes, one device each: ``data`` of -1
    fills what the other axes leave (a tensor axis of 2 over 2 processes
    leaves data 1); a layout that does not tile them raises the plan's
    ``MeshPlanError`` naming the device count (exit 2)."""
    from llmtrain_tpu_torch.autotune.plan import MeshPlanError
    from llmtrain_tpu_torch.config.schemas import RunConfig
    from llmtrain_tpu_torch.training.trainer import refuse_unported

    cfg = RunConfig.model_validate({
        "run": {"name": "m", "device": "cpu"}, "model": {"name": "dummy_gpt"},
        "data": {"name": "dummy_text"}, "trainer": {"max_steps": 2, "warmup_steps": 0},
        "mlflow": {"enabled": False}, "distributed": {"enabled": True, "mesh": mesh}})
    if refused:
        with pytest.raises(MeshPlanError, match=f"but {world} devices are available"):
            refuse_unported(cfg, world)
    else:
        refuse_unported(cfg, world)


def test_dropout_streams_fold_in_the_rank() -> None:
    """Rank 0 draws the one-process stream; other ranks draw their own."""
    from llmtrain_tpu_torch.training.train_step import dropout_generator

    def draw(**kw):
        return torch.rand(8, generator=dropout_generator(5, 3, 1, torch.device("cpu"), **kw))

    assert torch.equal(draw(), draw(rank=0))
    assert not torch.equal(draw(rank=0), draw(rank=1))
    assert not torch.equal(draw(rank=1), draw(rank=2))
