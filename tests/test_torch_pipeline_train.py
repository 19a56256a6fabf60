"""The port's ``gpt_pipeline`` trainer on pipeline meshes, as 8 gloo ranks
on the CPU, against the JAX trainer on the same mesh over its 8 virtual
CPU devices (``gpt_pipeline_smoke``'s model at a tiny width).

* ``{pipeline: 4, data: 2}`` (the preset's mesh): the per-step losses and
  final parameters track JAX's from JAX's initial parameters; every
  rank's gradients of the leaves outside the stages (the embeddings and
  ``ln_f``) after the step's reduction equal JAX's whole-model gradient;
  the eval, padded to ``lcm(dp, data shards x microbatches)`` rows,
  gives JAX's val loss; the interleaved schedule (two chunks a stage)
  tracks the same run; a resume at the same mesh repeats the run bit for
  bit, and one that changes ``pipeline`` exits 2.
* ``{pipeline: 2, tensor: 2, data: 2}`` with grouped-query heads: the
  same trajectory and gradient checks.

Bands: the optimizer trajectory's (atol 3e-5, rtol 1e-3) on losses and
parameters, the gradients' (atol 1e-5, rtol 1e-4).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from test_torch_mesh_train import STEPS, _assert_tracks, _jax_fit, _launch

TRAJ_ATOL, TRAJ_RTOL = 3e-5, 1e-3
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
OUTSIDE = ("token_embedding.weight", "position_embedding.weight", "ln_f_scale", "ln_f_bias")

def _raw(mesh: dict, **model) -> dict:
    extra = {"tokenizer": "byte", "pipeline_microbatches": 4, **model.pop("extra", {})}
    return {
        "schema_version": 1,
        "run": {"name": "pp", "seed": 1337, "device": "cpu", "deterministic": True},
        "model": {"name": "gpt_pipeline", "block_size": 8, "d_model": 32, "n_layers": 8,
                  "n_heads": 4, "d_ff": 64, "dropout": 0.0, "vocab_size": 256, **model,
                  "extra": extra},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 128, "micro_batch_size": 8, "grad_accum_steps": 1,
                    "lr": 0.003, "weight_decay": 0.01, "warmup_steps": 2, "max_grad_norm": 0.5,
                    "log_every_steps": 1, "eval_every_steps": 1000, "save_every_steps": 3},
        "distributed": {"enabled": True, "timeout_sec": 120, "mesh": mesh},
        "telemetry": {"enabled": False},
        "mlflow": {"enabled": False},
    }


def _probe_batch(tmp: Path, raw: dict, name: str) -> Path:
    """A global micro-batch of seeded tokens with a padded row, saved for
    the ranks."""
    rng = np.random.default_rng(7)
    dp = raw["distributed"]["mesh"].get("data", 1)
    shape = (raw["trainer"]["micro_batch_size"] * dp, raw["model"]["block_size"])
    ids = rng.integers(0, raw["model"]["vocab_size"], shape).astype(np.int32)
    mask = np.ones(shape, np.int32)
    mask[1, -3:] = 0
    path = tmp / f"{name}_probe.npz"
    np.savez(path, input_ids=ids, labels=np.roll(ids, -1, axis=1), attention_mask=mask)
    return path


def _jax_outside_grads(raw: dict, init: str, probe: Path) -> dict[str, np.ndarray]:
    """JAX's whole-model gradient of the probe batch's loss for the leaves
    outside the stages, in the port's names."""
    from llmtrain_tpu.config import RunConfig as JaxRunConfig
    from llmtrain_tpu.registry import get_model_adapter, initialize_registries
    from llmtrain_tpu_torch.interop import flax_params_to_state_dict

    initialize_registries()
    cfg = JaxRunConfig.model_validate({**raw, "distributed": {"enabled": False}})
    adapter = get_model_adapter("gpt_pipeline")()
    model = adapter.build_model(cfg)
    flat = dict(np.load(init))
    params: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = params
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    batch = {k: jnp.asarray(v) for k, v in np.load(probe).items()}

    def loss(p):
        ls, tk = adapter.compute_loss_components(model, p, batch)
        return jnp.sum(ls) / jnp.sum(tk)

    grads = jax.device_get(jax.grad(loss)(params))
    sd = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    return {k: sd[k].numpy() for k in OUTSIDE}


def _assert_outside_grads(port: list[dict], ref: dict, ranks: int = 8) -> None:
    assert len(port) == ranks
    for rank, got in enumerate(port):
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"rank {rank} {k}")


def test_pipeline_smoke_mesh_tracks_jax(tmp_path) -> None:
    """{pipeline: 4, data: 2}: trajectory, gradients, eval, the
    interleaved schedule, and resume (same mesh bitwise; pipeline changed
    refused)."""
    raw = _raw({"pipeline": 4, "data": 2})
    ref = _jax_fit(raw, tmp_path, with_val=True)
    probe = _probe_batch(tmp_path, raw, "pp")
    interleaved = _raw({"pipeline": 4, "data": 2},
                       extra={"pipeline_virtual_chunks": 2})
    ckpt = tmp_path / "ckpt"
    saved = ckpt / "checkpoints" / "step_000003.ckpt"
    runs = [
        dict(name="pp", raw=raw, steps=STEPS, init=ref["init"], probe=str(probe),
             probe_leaves=OUTSIDE, run_dir=str(ckpt), val=True),
        dict(name="interleaved", raw=interleaved, steps=STEPS, init=ref["init"]),
        dict(name="resumed", raw=raw, steps=STEPS, resume=str(saved)),
        dict(name="pipeline_changed", raw=_raw({"pipeline": 2, "data": 4}), steps=STEPS,
             resume=str(saved), expect_error=True),
    ]
    got = _launch(tmp_path, runs, world=8)
    _assert_tracks(got["pp"], ref)
    _assert_tracks(got["interleaved"], ref)
    # The run's parameter count is the whole model's (JAX's), not a stage's.
    assert got["pp"]["param_count"] == sum(v.size for v in ref["params"].values())
    _assert_outside_grads(got["pp"]["grads"], _jax_outside_grads(raw, ref["init"], probe))
    np.testing.assert_allclose(got["pp"]["val"], ref["val"], atol=TRAJ_ATOL, rtol=TRAJ_RTOL)
    # The same mesh resumes the saved run bit for bit.
    assert got["resumed"]["losses"] == got["pp"]["losses"][3:]
    for k, v in got["pp"]["params"].items():
        np.testing.assert_array_equal(got["resumed"]["params"][k], v, err_msg=k)
    refused = got["pipeline_changed"]
    assert refused["exit_code"] == 2 and "pipeline" in refused["error"], refused


def test_pipeline_tensor_mesh_tracks_jax(tmp_path) -> None:
    """{pipeline: 2, tensor: 2, data: 2} with grouped-query heads: each
    stage splits its heads and MLP width over tensor."""
    raw = _raw({"pipeline": 2, "tensor": 2, "data": 2}, n_layers=4,
               extra={"n_kv_heads": 2, "pipeline_microbatches": 2})
    ref = _jax_fit(raw, tmp_path)
    probe = _probe_batch(tmp_path, raw, "pptp")
    got = _launch(tmp_path, [dict(name="pptp", raw=raw, steps=STEPS, init=ref["init"],
                                  probe=str(probe), probe_leaves=OUTSIDE)], world=8)
    _assert_tracks(got["pptp"], ref)
    _assert_outside_grads(got["pptp"]["grads"], _jax_outside_grads(raw, ref["init"], probe))
