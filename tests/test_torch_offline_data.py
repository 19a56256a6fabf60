"""The port's offline data path against the JAX package's, on the CPU.

``dummy_text`` examples and splits, ``mixed_text`` windows, the trained
BPE vocabulary file, BPE ids of standard-library text (the native C
encoder and the Python one) and the token-cache identity of a BPE
vocabulary must be equal, not close: the data a run trains on is a pure
function of the config and the seed in both packages.
"""

from __future__ import annotations

import sysconfig
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.data.bpe import BPETokenizer as JaxBPE
from llmtrain_tpu.data.bpe import train_bpe as jax_train_bpe
from llmtrain_tpu.data.dummy_text import DummyTextDataModule as JaxDummyText
from llmtrain_tpu.data.local_text import LocalTextDataModule as JaxLocalText
from llmtrain_tpu.data.mixed_text import MixedTextDataModule as JaxMixedText
from llmtrain_tpu.data.tokenizers import ByteTokenizer as JaxByteTokenizer
from llmtrain_tpu.data.tokenizers import tokenizer_cache_id as jax_cache_id
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.data.bpe import BPETokenizer, train_bpe
from llmtrain_tpu_torch.data.dummy_text import DummyTextDataModule
from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
from llmtrain_tpu_torch.data.mixed_text import MixedTextDataModule
from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer, build_tokenizer, tokenizer_cache_id

VOCAB = torch_port_helpers.REPO_ROOT / "runs" / "pytok8k.json"


def _assert_datasets_equal(ours, theirs, label: str) -> None:
    assert len(ours) == len(theirs) > 0, label
    idx = np.arange(len(ours))[::-1]
    got, want = ours.get_examples(idx), theirs.get_examples(idx)
    assert got.keys() == want.keys(), label
    for key in want:
        assert got[key].dtype == want[key].dtype, f"{label}/{key}"
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{label}/{key}")


def _base_cfg(**model) -> dict:
    return {
        "run": {"name": "data", "device": "cpu", "seed": 11, "deterministic": True},
        "model": {"name": "gpt", "block_size": 8, "d_model": 32, "n_layers": 1, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, **model},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 10, "micro_batch_size": 4, "warmup_steps": 0},
    }


@pytest.mark.parametrize(
    "model, trainer, seed",
    [({"vocab_size": 64}, {}, 11), ({"block_size": 64, "vocab_size": 1000}, {}, 3),
     ({"vocab_size": None}, {"max_steps": 100, "micro_batch_size": 8}, 0),
     ({}, {"max_steps": 1, "micro_batch_size": 1}, 7)],
    ids=["smoke", "capped-seq-len", "capped-examples", "one-example"],
)
def test_dummy_text_equals_jax(model, trainer, seed) -> None:
    raw = _base_cfg(**model)
    raw["run"]["seed"] = seed
    raw["trainer"].update(trainer)
    ours, theirs = DummyTextDataModule(), JaxDummyText()
    ours.setup(RunConfig.model_validate(raw))
    theirs.setup(JaxRunConfig.model_validate(raw))
    for split in ("train_dataset", "val_dataset"):
        _assert_datasets_equal(getattr(ours, split)(), getattr(theirs, split)(), split)


def _seeded_text(seed: int, n_words: int) -> str:
    rng = np.random.default_rng(seed)
    words = ["def", "self", "return", " the", "value", "None", "import", "x", "==", "(", ")",
             "\n", "    ", "é", "日本", "print", "for", "in", "range", "0", "42"]
    return " ".join(rng.choice(words, size=n_words))


@pytest.mark.parametrize("vocab_size", [300, 600], ids=["v300", "v600"])
def test_trained_vocabulary_file_is_byte_identical(tmp_path, vocab_size: int) -> None:
    text = _seeded_text(5, 6000)
    ours, theirs = train_bpe(text, vocab_size), jax_train_bpe(text, vocab_size)
    ours.save(tmp_path / "port.json")
    theirs.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert (ours.n_vocab, ours.eot_token, ours.fingerprint) == \
        (theirs.n_vocab, theirs.eot_token, theirs.fingerprint)
    # Each package loads the other's file.
    assert BPETokenizer.load(tmp_path / "jax.json").fingerprint == theirs.fingerprint
    assert JaxBPE.load(tmp_path / "port.json").fingerprint == ours.fingerprint


def _stdlib_text() -> str:
    """About 200 KB of standard-library source, fixed files."""
    root = Path(sysconfig.get_paths()["stdlib"])
    names = ("argparse.py", "json/decoder.py", "textwrap.py", "dataclasses.py")
    return "\n\n".join((root / n).read_text(encoding="utf-8") for n in names)


@pytest.mark.parametrize("encoder", ["native", "python"])
def test_bpe_ids_of_stdlib_text_equal_jax(monkeypatch, encoder: str) -> None:
    if encoder == "python":
        monkeypatch.setenv("LLMTRAIN_NO_NATIVE", "1")
    ours = BPETokenizer.load(VOCAB)
    assert ours.encoder == encoder
    theirs = JaxBPE.load(VOCAB)
    text = _stdlib_text()
    ids = ours.encode_np(text)
    np.testing.assert_array_equal(ids, np.asarray(theirs.encode(text), np.int32))
    assert ours.decode(ids) == text
    assert ours.n_vocab == theirs.n_vocab == 8192


def test_bpe_cache_identity_equals_jax(tmp_path) -> None:
    """``tokenizer_cache_id`` keys local_text's token cache: for the tracked
    vocabulary it is JAX's string, so a local_text run of either package
    reuses the other's BPE token cache (one file, equal windows)."""
    ours, theirs = build_tokenizer(f"bpe:{VOCAB}"), JaxBPE.load(VOCAB)
    assert tokenizer_cache_id(ours) == jax_cache_id(theirs)
    assert tokenizer_cache_id(ours).startswith("BPETokenizer8192")
    assert tokenizer_cache_id(ours) != tokenizer_cache_id(ByteTokenizer())
    (tmp_path / "a.py").write_text(_stdlib_text()[:20000])
    raw = _base_cfg(block_size=64, extra={"tokenizer": f"bpe:{VOCAB}"})
    raw["data"] = {"name": "local_text", "cache_dir": str(tmp_path / "cache"),
                   "extra": {"globs": [str(tmp_path / "*.py")], "val_fraction": 0.1}}
    port_dm, jax_dm = LocalTextDataModule(), JaxLocalText()
    port_dm.setup(RunConfig.model_validate(raw), ours)
    cached = sorted((tmp_path / "cache" / "processed").iterdir())
    jax_dm.setup(JaxRunConfig.model_validate(raw), theirs)
    assert sorted((tmp_path / "cache" / "processed").iterdir()) == cached
    for split in ("train_dataset", "val_dataset"):
        _assert_datasets_equal(getattr(port_dm, split)(), getattr(jax_dm, split)(), split)


def _mixed_cfg(tmp_path: Path, seed: int, cache: str) -> dict:
    for name, n in (("a", 3), ("b", 2)):
        (tmp_path / name).mkdir(exist_ok=True)
        for i in range(n):
            (tmp_path / name / f"f{i}.txt").write_text(_seeded_text(10 * i + n, 200 + 50 * i))
    raw = _base_cfg(block_size=16, extra={"tokenizer": "byte"})
    raw["run"]["seed"] = seed
    raw["data"] = {"name": "mixed_text", "cache_dir": str(tmp_path / cache), "extra": {
        "sources": [{"globs": [str(tmp_path / "a" / "*.txt")], "weight": 3.0},
                    {"globs": [str(tmp_path / "b" / "*.txt")], "weight": 1.0,
                     "val_fraction": 0.2}]}}
    return raw


@pytest.mark.parametrize("seed", [0, 1337])
def test_mixed_text_windows_equal_jax(tmp_path, seed: int) -> None:
    ours, theirs = MixedTextDataModule(), JaxMixedText()
    ours.setup(RunConfig.model_validate(_mixed_cfg(tmp_path, seed, "port")), ByteTokenizer())
    theirs.setup(JaxRunConfig.model_validate(_mixed_cfg(tmp_path, seed, "jax")),
                 JaxByteTokenizer())
    np.testing.assert_array_equal(ours.train_dataset().source_histogram(),
                                  theirs.train_dataset().source_histogram())
    for split in ("train_dataset", "val_dataset"):
        _assert_datasets_equal(getattr(ours, split)(), getattr(theirs, split)(), split)


def test_mixed_text_refuses_as_jax(tmp_path) -> None:
    raw = _mixed_cfg(tmp_path, 0, "c")
    raw["data"]["extra"]["sources"][1]["weight"] = 0.0
    for module, cfg_cls in ((MixedTextDataModule(), RunConfig), (JaxMixedText(), JaxRunConfig)):
        with pytest.raises(ValueError, match="weight must be > 0"):
            module.setup(cfg_cls.model_validate(raw), ByteTokenizer())
