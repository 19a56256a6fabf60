"""Blockwise, ring and Ulysses attention of the port against JAX's
(llmtrain_tpu/ops/blockwise_attention.py, ring_attention.py,
ulysses_attention.py): forward and gradients with offsets, windows, key
and segment masks and grouped-query K/V; ring and Ulysses on 2 and 4 gloo
ranks against JAX's shard_map versions on as many virtual devices; the
ring's turns run in lockstep on one device against JAX's blockwise."""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import port_env

from llmtrain_tpu.config.schemas import MeshConfig as JaxMeshConfig
from llmtrain_tpu.distributed import build_mesh as jax_build_mesh
from llmtrain_tpu.ops.blockwise_attention import blockwise_attention as jax_blockwise
from llmtrain_tpu.ops.ring_attention import min_widen_factor as jax_min_widen_factor
from llmtrain_tpu.ops.ring_attention import ring_attention_sharded
from llmtrain_tpu.ops.ulysses_attention import ulysses_attention_sharded
from llmtrain_tpu_torch.ops.blockwise_attention import blockwise_attention
from llmtrain_tpu_torch.ops.ring_attention import min_widen_factor

FWD_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _inputs(seed: int, b: int, t: int, h: int, hkv: int, d: int, mask: str | None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    w = rng.normal(size=(b, t, h, d)).astype(np.float32)
    m = None
    if mask == "pad":
        lengths = rng.integers(t // 2, t + 1, size=b)
        m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    elif mask == "segment":
        m = np.ones((b, t), np.int32)
        m[:, 3 * t // 8:13 * t // 16] = 2  # a boundary off the shard edges
        m[:, 13 * t // 16:] = 0
    return q, k, v, w, m


def _jax_value_and_grads(fn, q, k, v, w, m):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, m) * w)

    out = jax.jit(lambda q, k, v: fn(q, k, v, m))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_close(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL, rtol=0)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"d{name}")


BLOCKWISE_CASES = {
    "causal": dict(kw={}, mask=None),
    "chunks": dict(kw=dict(q_chunk=8, kv_chunk=8), mask=None),
    "offsets": dict(kw=dict(q_chunk=8, kv_chunk=8, q_offset=16, kv_offset=8), mask=None),
    "window": dict(kw=dict(q_chunk=8, kv_chunk=8, window=5), mask=None),
    "key_mask": dict(kw=dict(kv_chunk=8), mask="pad"),
    "segments": dict(kw=dict(q_chunk=8, kv_chunk=8), mask="segment", segments=True),
    "gqa": dict(kw=dict(q_chunk=8, kv_chunk=8), mask=None, hkv=2),
    "gqa_segments": dict(kw=dict(kv_chunk=16, window=7), mask="segment", segments=True, hkv=1),
    "not_causal": dict(kw=dict(causal=False, kv_chunk=8), mask="pad"),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE_CASES))
def test_blockwise_matches_jax(case: str) -> None:
    spec = BLOCKWISE_CASES[case]
    q, k, v, w, m = _inputs(3, 2, 32, 4, spec.get("hkv", 4), 8, spec["mask"])
    kw = spec["kw"]
    seg = spec.get("segments", False)

    def jax_fn(q, k, v, m):
        return jax_blockwise(q, k, v, key_mask=m, query_mask=m if seg else None, **kw)

    ref_out, ref_grads = _jax_value_and_grads(jax_fn, q, k, v, w, m)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if m is None else torch.from_numpy(m)
    out = blockwise_attention(tq, tk, tv, key_mask=tm, query_mask=tm if seg else None, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_close(out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)],
                  ref_out, ref_grads)


@pytest.mark.parametrize("shards,hkv", [(2, 4), (4, 4), (4, 2)])
def test_ring_turns_in_lockstep_match_jax(shards: int, hkv: int) -> None:
    """The ring's own forward and backward turns, every shard a rank run
    in lockstep in one process (what the card's check drives), against
    JAX's causal blockwise attention; with each shard's K/V offset forced
    to 0 (a broken copy of the loop) the forward is off."""
    from llmtrain_tpu_torch.ops import ring_attention as ring

    q, k, v, w, _ = _inputs(7, 2, 32, 4, hkv, 8, None)
    ref_out, ref_grads = _jax_value_and_grads(
        lambda q, k, v, m: jax_blockwise(q, k, v, kv_chunk=8), q, k, v, w, None)
    got = ring.ring_turns_on_one_device(*(torch.from_numpy(x) for x in (q, k, v, w)), shards,
                                        kv_chunk=4)
    _assert_close(got[0].numpy(), [g.numpy() for g in got[1:]], ref_out, ref_grads)
    real = ring.chunk_scan
    ring.chunk_scan = lambda *a, kv_offset, **kw: real(*a, kv_offset=0, **kw)
    try:
        broken = ring.ring_turns_on_one_device(
            *(torch.from_numpy(x) for x in (q, k, v, w)), shards, kv_chunk=4)[0]
    finally:
        ring.chunk_scan = real
    assert np.abs(broken.numpy() - ref_out).max() > FWD_ATOL


def test_blockwise_refuses_as_jax_does() -> None:
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="window must be >= 0"):
        blockwise_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="sliding window requires causal"):
        blockwise_attention(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="requires key_mask"):
        blockwise_attention(q, q, q, query_mask=torch.ones(1, 8))


@pytest.mark.parametrize("group,kv,divisor", [(4, 2, 4), (4, 1, 4), (2, 2, 4), (3, 1, 2),
                                              (8, 1, 4), (1, 4, 4)])
def test_min_widen_factor_matches_jax(group: int, kv: int, divisor: int) -> None:
    assert min_widen_factor(group, kv, divisor) == jax_min_widen_factor(group, kv, divisor)


# --------------------------------------------------------------------------
# ring and Ulysses over gloo ranks
# --------------------------------------------------------------------------

SHARDED_CASES = {
    "ring_causal": dict(scheme="ring", mask=None, hkv=4),
    "ring_pad": dict(scheme="ring", mask="pad", hkv=4),
    "ring_segment": dict(scheme="ring", mask="segment", hkv=4),
    "ring_gqa": dict(scheme="ring", mask="pad", hkv=2),
    "ulysses_causal": dict(scheme="ulysses", mask=None, hkv=4),
    "ulysses_pad": dict(scheme="ulysses", mask="pad", hkv=4),
    "ulysses_segment": dict(scheme="ulysses", mask="segment", hkv=4),
    "ulysses_gqa": dict(scheme="ulysses", mask="pad", hkv=2),
}
SHAPE = dict(b=2, t=32, h=4, d=8)

# Each rank: the mesh (sequence = world), then every case on its own
# sequence shard; rank 0 writes the gathered outputs and gradients.
CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from llmtrain_tpu_torch.config.schemas import MeshConfig
from llmtrain_tpu_torch.distributed import build_mesh, set_active_mesh
from llmtrain_tpu_torch.ops.ring_attention import ring_attention_sharded
from llmtrain_tpu_torch.ops.ulysses_attention import ulysses_attention_sharded
spec = json.loads(sys.argv[1])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
                        rank=rank, world_size=world)
mesh = build_mesh(MeshConfig(data=1, sequence=world), world, rank)
set_active_mesh(mesh)
out = {}
for name, case in spec["cases"].items():
    arrays = np.load(case["inputs"])
    t = arrays["q"].shape[1] // world
    lo, hi = rank * t, (rank + 1) * t
    q, k, v = (torch.from_numpy(arrays[n][:, lo:hi].copy()).requires_grad_() for n in "qkv")
    m = torch.from_numpy(arrays["m"][:, lo:hi].copy()) if "m" in arrays.files else None
    fn = ring_attention_sharded if case["scheme"] == "ring" else ulysses_attention_sharded
    o = fn(q, k, v, mesh, key_mask=m)
    (o * torch.from_numpy(arrays["w"][:, lo:hi].copy())).sum().backward()
    for key, x in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.detach().contiguous())
        out[f"{name}/{key}"] = torch.cat(parts, dim=1).numpy()
if rank == 0:
    np.savez(spec["out"], **out)
dist.barrier()  # no rank leaves while another still holds the group
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path, world: int) -> dict:
    cases = {}
    for name, case in SHARDED_CASES.items():
        q, k, v, w, m = _inputs(11, SHAPE["b"], SHAPE["t"], SHAPE["h"], case["hkv"], SHAPE["d"],
                                case["mask"])
        path = tmp / f"{name}.npz"
        np.savez(path, q=q, k=k, v=v, w=w, **({} if m is None else {"m": m}))
        cases[name] = dict(scheme=case["scheme"], inputs=str(path))
    spec = json.dumps({"cases": cases, "out": str(tmp / "out.npz")})
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, spec], cwd=tmp,
                              env=port_env(RANK=str(r), WORLD_SIZE=str(world),
                                           MASTER_PORT=port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=180))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def sharded(request, tmp_path_factory) -> tuple[int, dict]:
    world = request.param
    return world, _launch(tmp_path_factory.mktemp(f"seq{world}"), world)


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_attention_matches_jax(sharded, case: str) -> None:
    world, got = sharded
    spec = SHARDED_CASES[case]
    q, k, v, w, m = _inputs(11, SHAPE["b"], SHAPE["t"], SHAPE["h"], spec["hkv"], SHAPE["d"],
                            spec["mask"])
    mesh = jax_build_mesh(JaxMeshConfig(data=1, sequence=world), jax.devices()[:world])
    fn = ring_attention_sharded if spec["scheme"] == "ring" else ulysses_attention_sharded
    ref_out, ref_grads = _jax_value_and_grads(
        lambda q, k, v, m: fn(q, k, v, mesh, key_mask=m), q, k, v, w, m)
    _assert_close(got[f"{case}/out"], [got[f"{case}/d{n}"] for n in "qkv"], ref_out, ref_grads)
