"""Torch checkpoint interop (llmtrain_tpu/interop/torch_interop.py).

The migration path in BOTH directions: export our GPT weights to a
torch-layout state dict, and rebuild our params from one. Correctness is
anchored to the parity-proven transforms of tests/test_torch_parity.py —
the exported dict must drive the torch mirror to the flax model's exact
logits, and import(export(params)) must be the identity.
"""

from __future__ import annotations

import json
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_port_helpers  # noqa: E402,F401 — caps torch at one CPU thread

from llmtrain_tpu.interop import (  # noqa: E402
    params_from_torch_state_dict,
    params_to_torch_state_dict,
)

# The parity-test mirror and helpers double as the reference
# implementation here (pytest puts tests/ on sys.path).
from test_torch_parity import T, V, _flax_gpt, _TorchGPT  # noqa: E402


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_roundtrip_is_identity(tie):
    _, params = _flax_gpt(tie)
    sd = params_to_torch_state_dict(params)
    back = params_from_torch_state_dict(sd, params)
    for (pa, va), (pb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(params),
        jax.tree_util.tree_leaves_with_path(back),
        strict=True,
    ):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_exported_state_dict_drives_torch_mirror(tie):
    """load_state_dict(exported) on the torch mirror reproduces the flax
    logits — the export really is the parity transplant."""
    model, params = _flax_gpt(tie)
    sd = {k: torch.from_numpy(v) for k, v in params_to_torch_state_dict(params).items()}
    mirror = _TorchGPT(tie)
    missing, unexpected = mirror.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    ids = np.random.default_rng(3).integers(0, V, size=(2, T), dtype=np.int64)
    import jax.numpy as jnp

    flax_logits = np.asarray(
        model.apply({"params": params}, jnp.asarray(ids, jnp.int32), deterministic=True)
    )
    with torch.no_grad():
        torch_logits = mirror(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(flax_logits, torch_logits, atol=2e-5, rtol=2e-5)


def test_import_rejects_missing_and_misshaped_keys():
    _, params = _flax_gpt(True)
    sd = params_to_torch_state_dict(params)
    incomplete = {k: v for k, v in sd.items() if k != "blocks.1.attn.qkv_proj.weight"}
    with pytest.raises(ValueError, match="missing 'blocks.1.attn.qkv_proj.weight'"):
        params_from_torch_state_dict(incomplete, params)
    bad = dict(sd)
    bad["ln_f.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="ln_f.weight"):
        params_from_torch_state_dict(bad, params)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_import_maps_legacy_export_format(tie):
    """Pre-alignment .pt files (tok.weight / blocks.{i}.qkv.*, no
    causal_mask buffers, no tied lm_head duplicate) still import."""
    _, params = _flax_gpt(tie)
    sd = params_to_torch_state_dict(params)
    legacy = {}
    for k, v in sd.items():
        if k.endswith(".attn.causal_mask"):
            continue  # legacy exports had no mask buffers
        if tie and k == "lm_head.weight":
            continue  # legacy tied exports omitted the duplicate
        k = k.replace("token_embedding.weight", "tok.weight")
        k = k.replace("position_embedding.weight", "pos.weight")
        k = k.replace(".attn.qkv_proj.", ".qkv.").replace(".attn.out_proj.", ".out_proj.")
        legacy[k] = v
    back = params_from_torch_state_dict(legacy, params)
    for (pa, va), (pb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(params),
        jax.tree_util.tree_leaves_with_path(back),
        strict=True,
    ):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_export_rejects_non_gpt_tree():
    with pytest.raises(ValueError, match="block_0"):
        params_to_torch_state_dict({"token_embedding": {"embedding": np.zeros((4, 2))},
                                    "position_embedding": {"embedding": np.zeros((4, 2))},
                                    "ln_f": {"scale": np.ones(2), "bias": np.zeros(2)}})


class TestExportCLI:
    def test_train_then_export(self, tmp_path):
        import yaml

        cfg = {
            "run": {"name": "export", "seed": 0, "device": "cpu"},
            "model": {
                "name": "gpt",
                "block_size": 8,
                "d_model": 16,
                "n_layers": 1,
                "n_heads": 4,
                "d_ff": 32,
                "dropout": 0.0,
                "vocab_size": 64,
                "extra": {"tokenizer": "byte"},
            },
            "data": {"name": "dummy_text"},
            "trainer": {
                "max_steps": 2,
                "micro_batch_size": 2,
                "grad_accum_steps": 1,
                "warmup_steps": 0,
                "log_every_steps": 1,
                "eval_every_steps": 2,
                "save_every_steps": 2,
            },
            "mlflow": {"enabled": False},
            "output": {"root_dir": str(tmp_path / "runs")},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))

        def run(argv):
            return subprocess.run(
                [sys.executable, "-m", "llmtrain_tpu", *argv],
                capture_output=True,
                text=True,
                timeout=300,
            )

        train = run(["train", "--config", str(cfg_path), "--run-id", "x", "--json"])
        assert train.returncode == 0, train.stderr
        out_pt = tmp_path / "export" / "model.pt"
        proc = run(
            [
                "export-checkpoint", "--config", str(cfg_path),
                "--from", "x", "--output", str(out_pt), "--json",
            ]
        )
        assert proc.returncode == 0, proc.stderr
        stats = json.loads(proc.stdout)
        sd = torch.load(out_pt, weights_only=True)
        assert stats["tensors"] == len(sd)
        assert "token_embedding.weight" in sd
        assert sd["token_embedding.weight"].shape == (64, 16)
        # Reference-format invariants: tied head materialized, persistent
        # causal-mask buffer present (reference gpt.py:32-33,143-146).
        assert "lm_head.weight" in sd
        assert sd["blocks.0.attn.causal_mask"].shape == (1, 1, 8, 8)
        assert stats["step"] == 2

    def test_bad_checkpoint_exit_1(self, tmp_path):
        import yaml

        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(
            yaml.safe_dump(
                {
                    "run": {"name": "x", "device": "cpu"},
                    "model": {
                        "name": "gpt", "block_size": 8, "d_model": 16,
                        "n_layers": 1, "n_heads": 4, "d_ff": 32,
                        "vocab_size": 64, "extra": {"tokenizer": "byte"},
                    },
                    "data": {"name": "dummy_text"},
                    "trainer": {"max_steps": 1, "micro_batch_size": 2, "warmup_steps": 0},
                    "mlflow": {"enabled": False},
                },
                sort_keys=False,
            )
        )
        proc = subprocess.run(
            [
                sys.executable, "-m", "llmtrain_tpu", "export-checkpoint",
                "--config", str(cfg_path), "--from", "no-such-run",
                "--output", str(tmp_path / "m.pt"),
            ],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1
        assert "export failed" in proc.stderr


def test_import_rejects_untied_head_into_tied_template():
    """The reference always emits lm_head.weight; for a tied template it
    must equal token_embedding.weight — a differing head means the source
    model was untied and silently dropping it would change logits."""
    _, params = _flax_gpt(True)  # tied: no lm_head in template
    sd = params_to_torch_state_dict(params)
    assert "lm_head.weight" in sd  # tied export still materializes it
    sd["lm_head.weight"] = np.zeros_like(sd["lm_head.weight"])
    with pytest.raises(ValueError, match="untied"):
        params_from_torch_state_dict(sd, params)


def test_tied_import_accepts_bf16_template():
    """The tied-duplicate equality check must compare raw sd values, not
    the template-dtype-cast tree — a bf16 param_dtype template would
    otherwise spuriously reject a genuinely tied f32 checkpoint."""
    import jax.numpy as jnp

    _, params = _flax_gpt(True)
    sd = params_to_torch_state_dict(params)
    bf16_template = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    back = params_from_torch_state_dict(sd, bf16_template)
    assert back["token_embedding"]["embedding"].dtype == jnp.bfloat16


def test_import_rejects_unconsumed_state_dict_keys():
    """An sd with weights the template cannot hold (deeper torch model)
    must fail, not silently drop them."""
    _, params = _flax_gpt(True)
    sd = params_to_torch_state_dict(params)
    sd["blocks.9.mlp_fc.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="cannot hold"):
        params_from_torch_state_dict(sd, params)


REFERENCE_SRC = __import__("os").environ.get(
    "LLMTRAIN_REFERENCE_SRC", "/root/reference/src"
)


@pytest.mark.skipif(
    not __import__("os").path.isdir(REFERENCE_SRC),
    reason="reference checkout not present (set LLMTRAIN_REFERENCE_SRC)",
)
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_exported_state_dict_loads_into_actual_reference_gpt(tie):
    """Ground truth for the migration claim: the export strict-loads into
    the REAL reference torch GPT (not our mirror) and reproduces the flax
    logits. Runs only where a reference checkout exists."""
    import sys

    sys.path.insert(0, REFERENCE_SRC)
    try:
        from llmtrain.models.gpt import GPT as RefGPT  # type: ignore[import-not-found]
    finally:
        sys.path.remove(REFERENCE_SRC)

    model, params = _flax_gpt(tie)
    ref = RefGPT(
        vocab_size=V, block_size=T, d_model=32, n_layers=2, n_heads=4,
        d_ff=64, dropout=0.0, tie_embeddings=tie,
    )
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in params_to_torch_state_dict(params).items()}
    missing, unexpected = ref.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    # Normalize the one documented divergence (docs/parity.md): flax
    # LayerNorm eps=1e-6 vs torch default 1e-5.
    for m in ref.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = 1e-6
    ref.eval()
    ids = np.random.default_rng(5).integers(0, V, size=(2, T), dtype=np.int64)
    import jax.numpy as jnp

    flax_logits = np.asarray(
        model.apply({"params": params}, jnp.asarray(ids, jnp.int32), deterministic=True)
    )
    with torch.no_grad():
        ref_logits = ref(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(flax_logits, ref_logits, atol=2e-5, rtol=2e-5)


def test_moe_export_raises_clear_error():
    """MoE params (moe_mlp experts) have no reference counterpart; export
    must say so instead of a bare KeyError('mlp_fc')."""
    _, params = _flax_gpt(True)
    moe = dict(params)
    blk = dict(params["block_0"])
    blk["moe_mlp"] = blk.pop("mlp_fc")
    moe["block_0"] = blk
    with pytest.raises(ValueError, match="n_experts"):
        params_to_torch_state_dict(moe)


def test_gqa_export_raises_clear_error():
    """GQA params (split q_proj/kv_proj) have no reference checkpoint
    format; export must say so instead of dying with a bare KeyError."""
    _, params = _flax_gpt(True)
    gqa = dict(params)
    blk = dict(params["block_0"])
    att = dict(blk["attn"])
    att["q_proj"] = att.pop("qkv_proj")
    blk["attn"] = att
    gqa["block_0"] = blk
    with pytest.raises(ValueError, match="n_kv_heads"):
        params_to_torch_state_dict(gqa)


class TestImportCLI:
    @pytest.mark.slow  # ~20s: four CLI subprocesses end to end. The
    # export/import conversion math stays tier-1 (round-trip units above
    # and TestExportCLI's train->export run).
    def test_full_migration_loop(self, tmp_path):
        """train -> export-checkpoint -> import-checkpoint -> eval: the
        re-imported checkpoint evaluates to the original's exact val loss,
        and training can resume from it."""
        import yaml

        cfg = {
            "run": {"name": "migrate", "seed": 0, "device": "cpu"},
            "model": {
                "name": "gpt",
                "block_size": 8,
                "d_model": 16,
                "n_layers": 1,
                "n_heads": 4,
                "d_ff": 32,
                "dropout": 0.0,
                "vocab_size": 64,
                "extra": {"tokenizer": "byte"},
            },
            "data": {"name": "dummy_text"},
            "trainer": {
                "max_steps": 3,
                "micro_batch_size": 2,
                "grad_accum_steps": 1,
                "warmup_steps": 0,
                "log_every_steps": 1,
                "eval_every_steps": 3,
                "save_every_steps": 3,
            },
            "mlflow": {"enabled": False},
            "output": {"root_dir": str(tmp_path / "runs")},
        }
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))

        def run(argv):
            return subprocess.run(
                [sys.executable, "-m", "llmtrain_tpu", *argv],
                capture_output=True,
                text=True,
                timeout=300,
            )

        train = run(["train", "--config", str(cfg_path), "--run-id", "src", "--json"])
        assert train.returncode == 0, train.stderr

        pt = tmp_path / "model.pt"
        exp = run(
            ["export-checkpoint", "--config", str(cfg_path), "--from", "src",
             "--output", str(pt), "--json"]
        )
        assert exp.returncode == 0, exp.stderr

        ckpt_dir = tmp_path / "imported"
        imp = run(
            ["import-checkpoint", "--config", str(cfg_path), "--input", str(pt),
             "--output", str(ckpt_dir), "--json"]
        )
        assert imp.returncode == 0, imp.stderr
        assert (ckpt_dir / "step_000000.ckpt").exists()

        ev_src = run(["eval", "--config", str(cfg_path), "--from", "src", "--json"])
        ev_imp = run(
            ["eval", "--config", str(cfg_path), "--from", str(ckpt_dir), "--json"]
        )
        assert ev_src.returncode == 0 and ev_imp.returncode == 0, ev_imp.stderr
        src_loss = json.loads(ev_src.stdout)["metrics"]["val/loss"]
        imp_loss = json.loads(ev_imp.stdout)["metrics"]["val/loss"]
        assert abs(src_loss - imp_loss) < 1e-6

        # And training resumes from the imported step-0 checkpoint.
        cont = run(
            ["train", "--config", str(cfg_path), "--run-id", "cont", "--json",
             "--resume", str(ckpt_dir)]
        )
        assert cont.returncode == 0, cont.stderr
        result = json.loads(cont.stdout)["train_result"]
        assert result["final_step"] == 3
        assert result["resumed_from_step"] == 0

    def test_bad_input_exit_1(self, tmp_path):
        import yaml

        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(
            yaml.safe_dump(
                {
                    "run": {"name": "x", "device": "cpu"},
                    "model": {
                        "name": "gpt", "block_size": 8, "d_model": 16,
                        "n_layers": 1, "n_heads": 4, "d_ff": 32,
                        "vocab_size": 64, "extra": {"tokenizer": "byte"},
                    },
                    "data": {"name": "dummy_text"},
                    "trainer": {"max_steps": 1, "micro_batch_size": 2, "warmup_steps": 0},
                    "mlflow": {"enabled": False},
                },
                sort_keys=False,
            )
        )
        proc = subprocess.run(
            [
                sys.executable, "-m", "llmtrain_tpu", "import-checkpoint",
                "--config", str(cfg_path), "--input", str(tmp_path / "nope.pt"),
                "--output", str(tmp_path / "out"),
            ],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1
        assert "import failed" in proc.stderr

    def test_refuses_nonempty_output_dir(self, tmp_path):
        import yaml

        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(
            yaml.safe_dump(
                {
                    "run": {"name": "x", "device": "cpu"},
                    "model": {
                        "name": "gpt", "block_size": 8, "d_model": 16,
                        "n_layers": 1, "n_heads": 4, "d_ff": 32,
                        "vocab_size": 64, "extra": {"tokenizer": "byte"},
                    },
                    "data": {"name": "dummy_text"},
                    "trainer": {"max_steps": 1, "micro_batch_size": 2, "warmup_steps": 0},
                    "mlflow": {"enabled": False},
                },
                sort_keys=False,
            )
        )
        out = tmp_path / "ckpts"
        out.mkdir()
        (out / "step_000300.ckpt").write_bytes(b"x")
        pt = tmp_path / "m.pt"
        _, params = _flax_gpt(True)
        torch.save(
            {k: torch.from_numpy(v) for k, v in params_to_torch_state_dict(params).items()},
            pt,
        )
        proc = subprocess.run(
            [
                sys.executable, "-m", "llmtrain_tpu", "import-checkpoint",
                "--config", str(cfg_path), "--input", str(pt), "--output", str(out),
            ],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1
        assert "already holds checkpoints" in proc.stderr
        assert (out / "step_000300.ckpt").exists()  # untouched

    def test_bf16_state_dict_imports(self, tmp_path):
        """torch bf16 tensors can't .numpy() directly; the importer must
        still accept bf16-saved reference checkpoints."""
        import yaml

        _, params = _flax_gpt(True)
        sd = {
            k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in params_to_torch_state_dict(params).items()
        }
        pt = tmp_path / "bf16.pt"
        torch.save(sd, pt)
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(
            yaml.safe_dump(
                {
                    "run": {"name": "x", "device": "cpu"},
                    "model": {
                        "name": "gpt", "block_size": T, "d_model": 32,
                        "n_layers": 2, "n_heads": 4, "d_ff": 64,
                        "vocab_size": V, "extra": {"tokenizer": "byte"},
                    },
                    "data": {"name": "dummy_text"},
                    "trainer": {"max_steps": 1, "micro_batch_size": 2, "warmup_steps": 0},
                    "mlflow": {"enabled": False},
                },
                sort_keys=False,
            )
        )
        proc = subprocess.run(
            [
                sys.executable, "-m", "llmtrain_tpu", "import-checkpoint",
                "--config", str(cfg_path), "--input", str(pt),
                "--output", str(tmp_path / "out"), "--json",
            ],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        assert (tmp_path / "out" / "step_000000.ckpt").exists()
