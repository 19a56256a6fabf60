"""The port's Mixture of Experts against the JAX package's, on the CPU.

* ``MoEMLP`` routing, top-1 and top-2, with and without drops, and with
  tied router probabilities: the (B, T, E, C) dispatch tensor equal to
  JAX's exactly (recorded at JAX's dispatch einsum), the combine tensor's
  support equal exactly and its weights within 1e-6, the drop counts
  equal, the load-balance loss and the layer's output within 2e-5;
* ``gpt_moe`` and ``llama_moe`` (the Mixtral layout: SwiGLU experts, top 2,
  a window) built by their adapters from one config: the loss components
  with the aux folded in and the gradients (atol 1e-5, rtol 1e-4), the
  experts carried over both ways, and ``gpt_moe_smoke`` with its mesh
  cleared tracking JAX's trainer within the trajectory band (atol 3e-5,
  rtol 1e-3) from JAX's initial params;
* a decode cache over the MoE blocks against the full forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import REPO_ROOT, paired_fit, random_params, seeded_ids, to_torch

import llmtrain_tpu.models.moe as jax_moe
from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.models.gpt_moe import GPTMoEAdapter as JaxGPTMoE
from llmtrain_tpu.models.llama import LlamaMoEAdapter as JaxLlamaMoE
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.interop.flax_params import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from llmtrain_tpu_torch.models.gpt_moe import GPTMoEAdapter
from llmtrain_tpu_torch.models.llama import LlamaMoEAdapter
from llmtrain_tpu_torch.models.moe import MoEMLP

ATOL = RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
D, F, E = 16, 24, 4


class _DispatchRecorder:
    """Stands in for ``jnp`` inside llmtrain_tpu/models/moe.py and keeps
    the dispatch and combine tensors its two routing einsums receive."""

    def __init__(self) -> None:
        self.seen: dict[str, np.ndarray] = {}

    def __getattr__(self, name: str):
        return getattr(jnp, name)

    def einsum(self, spec: str, *operands, **kw):
        if spec == "btec,btd->ebcd":
            self.seen["dispatch"] = np.asarray(operands[0])
        elif spec == "btec,ebcd->btd":
            self.seen["combine"] = np.asarray(operands[0])
        return jnp.einsum(spec, *operands, **kw)


def _jax_route(monkeypatch, module, params, x):
    recorder = _DispatchRecorder()
    monkeypatch.setattr(jax_moe, "jnp", recorder)
    out, mutated = module.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    monkeypatch.undo()
    aux = float(jax.tree.leaves(mutated["losses"])[0])
    return recorder.seen["dispatch"], recorder.seen["combine"], np.asarray(out), aux


def _port_moe(module, params, mlp_type: str) -> MoEMLP:
    moe = MoEMLP(D, F, E, dtype=torch.float32, param_dtype=torch.float32,
                 capacity_factor=module.capacity_factor, aux_loss_weight=module.aux_loss_weight,
                 router_top_k=module.router_top_k, mlp_type=mlp_type)
    sd = flax_params_to_state_dict({"token_embedding": {"embedding": np.zeros((2, D))},
                                    "block_0": {"moe_mlp": params}})
    moe.load_state_dict({k.split("moe_mlp.")[1]: v for k, v in sd.items() if "moe_mlp" in k},
                        strict=True)
    return moe


ROUTING = [
    dict(router_top_k=1, capacity_factor=1.25, mlp_type="gelu", router_scale=0.1),
    dict(router_top_k=2, capacity_factor=2.0, mlp_type="swiglu", router_scale=0.1),
    dict(router_top_k=1, capacity_factor=0.5, mlp_type="gelu", router_scale=3.0),
    dict(router_top_k=2, capacity_factor=0.75, mlp_type="swiglu", router_scale=3.0),
    dict(router_top_k=2, capacity_factor=1.0, mlp_type="gelu", router_scale=0.0),
]


@pytest.mark.parametrize("case", ROUTING, ids=["top1", "top2", "top1-drops", "top2-drops",
                                               "top2-ties"])
def test_routing_equals_jax(monkeypatch, case: dict) -> None:
    """``router_scale`` 3 skews the router so that experts overflow; 0
    makes every probability equal, so each choice is a tie that both
    argmaxes must break to the first index."""
    module = jax_moe.MoEMLP(d_model=D, d_ff=F, n_experts=E, n_layers=2,
                            capacity_factor=case["capacity_factor"],
                            router_top_k=case["router_top_k"], mlp_type=case["mlp_type"])
    x = np.random.default_rng(1).normal(size=(3, 20, D)).astype(np.float32)
    params = random_params(module, jnp.zeros((1, 20, D)), seed=2)
    params["router"]["kernel"] = params["router"]["kernel"] * case["router_scale"]
    dispatch, combine, out, aux = _jax_route(monkeypatch, module, params, x)
    moe = _port_moe(module, params, case["mlp_type"])
    with torch.no_grad():
        p_dispatch, p_combine, p_aux = moe.route(to_torch(x))
        p_out = moe(to_torch(x))
    np.testing.assert_array_equal(p_dispatch.numpy(), dispatch)
    np.testing.assert_array_equal(p_combine.numpy() != 0, combine != 0)
    np.testing.assert_allclose(p_combine.numpy(), combine, atol=1e-6, rtol=1e-6)
    dropped = case["router_top_k"] * 3 * 20 - dispatch.sum()
    assert case["router_top_k"] * 3 * 20 - float(p_dispatch.sum()) == dropped
    if case["router_scale"] == 3.0:
        assert dropped > 0
    if case["router_scale"] == 0.0:
        # Ties: every token's first choice is expert 0, its second expert 1.
        assert set(np.nonzero(dispatch.sum(axis=(0, 1, 3)))[0]) <= {0, 1}
    assert abs(float(p_aux) - aux) <= ATOL + RTOL * abs(aux)
    np.testing.assert_allclose(p_out.numpy(), out, atol=ATOL, rtol=RTOL)


def _raw(name: str, **extra) -> dict:
    return {
        "run": {"name": "moe", "device": "cpu", "seed": 4},
        "model": {"name": name, "block_size": 16, "d_model": 32, "n_layers": 2, "n_heads": 4,
                  "d_ff": 48, "dropout": 0.0, "vocab_size": 53,
                  "extra": {"n_experts": 4, **extra}},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 2, "warmup_steps": 0},
    }


MODELS = {
    "gpt_moe": (JaxGPTMoE, GPTMoEAdapter, {"capacity_factor": 1.0, "moe_aux_weight": 0.05}),
    "llama_moe": (JaxLlamaMoE, LlamaMoEAdapter, {"router_top_k": 2, "capacity_factor": 2.0,
                                                 "sliding_window": 6, "n_kv_heads": 2}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def moe_model(request):
    jax_cls, port_cls, extra = MODELS[request.param]
    raw = _raw(request.param, **extra)
    jm = jax_cls().build_model(JaxRunConfig.model_validate(raw))
    params = random_params(jm, jnp.zeros((1, 16), jnp.int32), seed=5)
    tm = port_cls().build_model(RunConfig.model_validate(raw))
    tm.load_state_dict(flax_params_to_state_dict(serialization.to_state_dict(params)),
                       strict=True)
    return request.param, jax_cls(), jm, params, port_cls(), tm


def test_loss_with_aux_and_gradients_match_jax(moe_model) -> None:
    name, jax_adapter, jm, params, port_adapter, tm = moe_model
    ids = seeded_ids(6, (3, 17), 53)
    mask = np.ones((3, 16), np.int32)
    mask[2, 11:] = 0
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:], "attention_mask": mask}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        loss_sum, tokens = jax_adapter.compute_loss_components(jm, p, jbatch)
        return jnp.sum(loss_sum) / jnp.sum(tokens), (loss_sum, tokens)

    (jloss, (jsum, jtok)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tm.zero_grad()
    loss_sum, tokens = port_adapter.compute_loss_components(
        tm, {k: to_torch(v) for k, v in batch.items()})
    (loss_sum.sum() / tokens.sum()).backward()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(loss_sum.detach().numpy(), np.asarray(jsum), atol=ATOL,
                               rtol=RTOL)
    want = flax_params_to_state_dict(jax.device_get(serialization.to_state_dict(jgrads)))
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{name}: {pname}")


def test_aux_is_folded_into_the_loss(moe_model) -> None:
    """The objective is CE + the layers' aux exactly: the loss components
    less the dense CE of the same logits are the aux times the tokens."""
    from llmtrain_tpu_torch.models.base import masked_ce_components
    from llmtrain_tpu_torch.models.moe import take_aux_loss

    name, _, _, _, port_adapter, tm = moe_model
    ids = to_torch(seeded_ids(7, (2, 17), 53)).long()
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    with torch.no_grad():
        loss_sum, tokens = port_adapter.compute_loss_components(tm, batch)
        ce_sum, _ = masked_ce_components(tm(batch["input_ids"]), batch["labels"], None)
        aux = take_aux_loss(tm)
    assert aux is not None and float(aux) > 0
    np.testing.assert_allclose((loss_sum - ce_sum).numpy(), (aux * tokens).numpy(), rtol=1e-5)
    assert take_aux_loss(tm) is None  # taken once


def test_experts_carry_over_both_ways(moe_model) -> None:
    name, _, jm, params, _, tm = moe_model
    back = state_dict_to_flax_params(tm.state_dict(), n_heads=4,
                                     n_kv_heads=2 if name == "llama_moe" else 0)
    flat = jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(params))
    mine = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), back)))
    assert len(mine) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(mine[path], np.asarray(leaf), str(path))


def test_decode_cache_matches_full_forward() -> None:
    """The Mixtral layout: a prefill within the window, then one token a
    call past it; at capacity factor 2 no choice drops, so each call's
    routing is the full forward's."""
    _, port_cls, extra = MODELS["llama_moe"]
    tm = port_cls().build_model(RunConfig.model_validate(_raw("llama_moe", **extra)))
    ids = to_torch(seeded_ids(8, (2, 14), 53)).long()
    decoder = tm.for_decoding()
    cache = decoder.init_cache(2)
    with torch.no_grad():
        got = torch.cat([decoder(ids[:, :4], cache)]
                        + [decoder(ids[:, t:t + 1], cache) for t in range(4, 14)], dim=1)
        full = tm(ids)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL, rtol=RTOL)


def test_gpt_moe_smoke_tracks_jax_with_the_mesh_cleared(tmp_path) -> None:
    raw = yaml.safe_load((REPO_ROOT / "configs/presets/gpt_moe_smoke.yaml").read_text())
    raw["distributed"] = {"enabled": False}
    raw["run"]["deterministic"] = True
    raw["trainer"].update(max_steps=128, micro_batch_size=8, warmup_steps=2, log_every_steps=1,
                          eval_every_steps=100, save_every_steps=100)
    raw["output"]["root_dir"] = str(tmp_path / "runs")
    raw["telemetry"] = {"enabled": False}
    jax_losses, port_losses, _, _ = paired_fit(raw, tmp_path, steps=3)
    assert len(port_losses) == len(jax_losses) == 3
    np.testing.assert_allclose(port_losses, jax_losses, atol=TRAJ_ATOL, rtol=TRAJ_RTOL)


def test_int8_quantization_of_the_experts_matches_jax(moe_model) -> None:
    """``--quantize int8`` on an MoE model: the stacked experts take JAX's
    rule (scales over the largest leading axis), codes equal to JAX's,
    and the quantized model still runs."""
    from llmtrain_tpu.ops.quant import quantize_tree as jax_quantize_tree
    from llmtrain_tpu_torch.ops.quant import model_tree, quantize_model

    import copy

    name, _, _, params, _, tm = moe_model
    theirs = jax_quantize_tree(params, min_size=64)
    model = copy.deepcopy(tm)
    quantize_model(model, min_size=64)
    tree = model_tree(model)
    for leaf in ("wi", "bi", "wo", "bo", "wg", "wu"):
        key = f"blocks.0.moe_mlp.{leaf}"
        if key not in tree:
            continue
        want = theirs["block_0"]["moe_mlp"][leaf]
        np.testing.assert_array_equal(tree[key].q.numpy(), np.asarray(want.q), f"{name}: {leaf}")
    with torch.no_grad():
        model(to_torch(seeded_ids(10, (1, 8), 53)).long())
