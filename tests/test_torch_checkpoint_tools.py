"""The port's offline tools against the JAX CLI's, on a tiny GPT checkpoint
the port's ``train`` wrote (2 layers, byte vocabulary, saves at steps 2
and 4), on the CPU.

* ``export-checkpoint``: the port's file equals JAX's export of the same
  checkpoint key for key, exactly (dtypes, shapes, values, the
  ``causal_mask`` buffers and the tied ``lm_head.weight``);
* ``import-checkpoint`` of that file: params equal to JAX's import; the
  port's ``train --resume`` continues from it;
* ``eval``: ``val/loss`` within 2e-5 of JAX's ``eval`` on the same params
  (JAX evaluates the checkpoint its own import wrote: its trainer restores
  the optimizer state too, which the port keeps in its own layout), with
  and without ``--quantize int8``;
* ``average-checkpoints`` (an explicit list and ``--last-k``): params equal
  to JAX's exactly (float64 accumulation in both);
* ``train-tokenizer --json``: the same stats and a byte-identical file.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train_cli import _config
from torch_port_helpers import run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

EVAL_TOL = 2e-5


@pytest.fixture(scope="module")
def trained(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("tools")
    cfg = _config(root)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "p", "--json"]) == 0
    ckpts = root / "runs" / "p" / "checkpoints"
    return {"root": root, "cfg": str(cfg), "ckpts": ckpts}


def _out(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _err(capsys) -> str:
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_params_equal(ours: Path, theirs: Path) -> None:
    a = dict(_leaves(CheckpointManager.load(ours)["params"]))
    b = dict(_leaves(CheckpointManager.load(theirs)["params"]))
    assert a.keys() == b.keys()
    for key in b:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


def _export(main, trained, name: str, capsys, *extra: str) -> tuple[int, Path]:
    out = trained["root"] / f"{name}.pt"
    code = run_cli(main, ["export-checkpoint", "--config", trained["cfg"], "--from",
                          str(trained["ckpts"]), "--output", str(out), "--json", *extra])
    return code, out


def test_export_equals_jax_key_for_key(trained, capsys) -> None:
    code, ours_path = _export(port_main, trained, "port", capsys)
    assert code == 0
    ours_stats = _out(capsys)
    code, theirs_path = _export(jax_main, trained, "jax", capsys)
    assert code == 0
    theirs_stats = _out(capsys)
    for key in ("step", "tensors", "parameters"):
        assert ours_stats[key] == theirs_stats[key], key
    assert ours_stats["step"] == 4
    ours = torch.load(ours_path, weights_only=True)
    theirs = torch.load(theirs_path, weights_only=True)
    assert list(ours) == list(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got, want), key
    assert ours["blocks.0.attn.causal_mask"].dtype == torch.bool
    # Tied: the file still holds lm_head.weight, the token embedding's values.
    assert torch.equal(ours["lm_head.weight"], ours["token_embedding.weight"])


@pytest.fixture(scope="module")
def imported(trained) -> dict:
    """The port's export imported by each CLI into its own directory."""
    out = trained["root"] / "for_import.pt"
    assert run_cli(port_main, ["export-checkpoint", "--config", trained["cfg"], "--from",
                               str(trained["ckpts"]), "--output", str(out)]) == 0
    dirs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        dirs[name] = trained["root"] / f"imported_{name}"
        assert run_cli(main, ["import-checkpoint", "--config", trained["cfg"], "--input",
                              str(out), "--output", str(dirs[name]), "--json"]) == 0
    return {"pt": out, **dirs}


def test_import_equals_jax_and_resumes(trained, imported, capsys) -> None:
    ours = imported["port"] / "step_000000.ckpt"
    theirs = imported["jax"] / "step_000000.ckpt"
    _assert_params_equal(ours, theirs)
    # The import holds the trained step-4 params, and the commit manifest.
    _assert_params_equal(ours, trained["ckpts"] / "step_000004.ckpt")
    assert (imported["port"] / "step_000000.manifest.json").is_file()
    payload = CheckpointManager.load(ours)
    assert int(payload["step"]) == 0 and int(payload["opt_state"]["count"]) == 0
    assert run_cli(port_main, ["train", "--config", trained["cfg"], "--run-id", "from_import",
                               "--resume", str(imported["port"]), "--json"]) == 0
    result = _out(capsys)["train_result"]
    assert result["resumed_from_step"] == 0 and result["final_step"] == 4
    # An occupied output directory is refused, as in JAX (exit 1).
    for main in (port_main, jax_main):
        assert run_cli(main, ["import-checkpoint", "--config", trained["cfg"], "--input",
                              str(imported["pt"]), "--output", str(imported["port"])]) == 1
        assert "already holds checkpoints" in _err(capsys)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_eval_matches_jax(trained, imported, capsys, quantize: str) -> None:
    argv = ["eval", "--config", trained["cfg"], "--quantize", quantize, "--json", "--from"]
    assert run_cli(port_main, argv + [str(trained["ckpts"])]) == 0
    ours = _out(capsys)["metrics"]["val/loss"]
    assert run_cli(jax_main, argv + [str(imported["jax"])]) == 0
    theirs = _out(capsys)["metrics"]["val/loss"]
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, atol=EVAL_TOL, rtol=EVAL_TOL)
    # The port's eval of the port's import reads the same params.
    assert run_cli(port_main, argv + [str(imported["port"])]) == 0
    assert _out(capsys)["metrics"]["val/loss"] == ours


def test_eval_without_a_validation_split_answers_as_jax(tmp_path, capsys) -> None:
    cfg = _config(tmp_path, **{"data.extra.val_fraction": 0.0})
    answers = []
    for main in (jax_main, port_main):
        answers.append((run_cli(main, ["eval", "--config", str(cfg)]), _err(capsys)))
    assert answers[0] == answers[1] == (1, "data module has no validation split to evaluate")


@pytest.mark.parametrize("mode", ["explicit", "last-k"])
def test_average_equals_jax(trained, capsys, mode: str) -> None:
    ckpts = trained["ckpts"]
    if mode == "explicit":
        inputs = ["--inputs", f"{ckpts / 'step_000002.ckpt'},{ckpts / 'step_000004.ckpt'}"]
    else:
        inputs = ["--inputs", str(ckpts), "--last-k", "2"]
    stats = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = trained["root"] / f"avg_{mode}_{name}"
        assert run_cli(main, ["average-checkpoints", "--config", trained["cfg"], *inputs,
                              "--output", str(out), "--json"]) == 0
        stats[name] = _out(capsys)
    assert stats["port"]["steps"] == stats["jax"]["steps"] == [2, 4]
    assert stats["port"]["inputs"] == stats["jax"]["inputs"]
    _assert_params_equal(Path(stats["port"]["checkpoint"]), Path(stats["jax"]["checkpoint"]))


@pytest.mark.parametrize(
    "argv",
    [["--inputs", "a"], ["--inputs", "a,b", "--last-k", "2"], ["--inputs", "d", "--last-k", "1"]],
    ids=["one-input", "last-k-with-a-list", "last-k-below-2"],
)
def test_average_refusals_answer_as_jax(trained, capsys, argv) -> None:
    answers = []
    for main in (jax_main, port_main):
        out = trained["root"] / "avg_refused"
        code = run_cli(main, ["average-checkpoints", "--config", trained["cfg"], *argv,
                              "--output", str(out)])
        answers.append((code, _err(capsys)))
    assert answers[0] == answers[1] and answers[0][0] == 2, answers


@pytest.mark.parametrize("command", ["export-checkpoint", "eval"])
def test_ema_refuses_citing_a_stable_item(trained, capsys, command: str) -> None:
    """What the refusal of ``--ema`` became: on a checkpoint without an
    EMA shadow both CLIs answer with the same exit code and error (JAX's
    ``eval`` restores the optimizer state, so it reads a checkpoint of its
    own: JAX's import of the port's export)."""
    ckpt = str(trained["ckpts"])
    if command == "eval":
        exported, imported = trained["root"] / "ema_src.pt", trained["root"] / "ema_src"
        assert run_cli(port_main, ["export-checkpoint", "--config", trained["cfg"], "--from",
                                   ckpt, "--output", str(exported)]) == 0
        assert run_cli(jax_main, ["import-checkpoint", "--config", trained["cfg"], "--input",
                                  str(exported), "--output", str(imported)]) == 0
        capsys.readouterr()
        ckpt = str(imported)
    argv = [command, "--config", trained["cfg"], "--from", ckpt, "--ema"]
    if command == "export-checkpoint":
        argv += ["--output", str(trained["root"] / "ema.pt")]
    answers = [(run_cli(main, argv), _err(capsys)) for main in (jax_main, port_main)]
    assert answers[0] == answers[1] and answers[0][0] != 0, answers
    assert "EMA state" in answers[0][1]


def test_train_tokenizer_equals_jax(tmp_path, capsys) -> None:
    rng = np.random.default_rng(4)
    words = ["def", "return", "self", "value", "import", "class", "(", ")", ":", "\n", "é"]
    (tmp_path / "corpus" / "sub").mkdir(parents=True)
    for i, name in enumerate(("a.py", "b.md", "sub/c.txt", "sub/skip.json")):
        (tmp_path / "corpus" / name).write_text(" ".join(rng.choice(words, size=3000 + 500 * i)))
    stats = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = tmp_path / f"{name}.json"
        # The directory twice and one of its files: de-duplicated by path.
        assert run_cli(main, ["train-tokenizer", "--input", str(tmp_path / "corpus"),
                              "--input", str(tmp_path / "corpus" / "a.py"),
                              "--input", str(tmp_path / "corpus"), "--vocab-size", "400",
                              "--max-bytes", "30000", "--output", str(out), "--json"]) == 0
        stats[name] = _out(capsys)
        stats[name].pop("output"), stats[name].pop("train_seconds")
    assert stats["port"] == stats["jax"]
    assert stats["port"]["files"] == 3 and stats["port"]["corpus_bytes"] <= 30000 + 8
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    for main in (port_main, jax_main):
        assert run_cli(main, ["train-tokenizer", "--input", str(tmp_path / "nowhere"),
                              "--output", str(tmp_path / "x.json")]) == 2
        assert _err(capsys).startswith("input path not found")
