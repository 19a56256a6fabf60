"""The port's data path against the JAX package's.

The sampler's index stream and the local_text windows (train and val,
packed and with document segments) must be equal, not close: the data a
run trains on is a pure function of the config and the seed in both
packages. The corpus is a seeded temp directory of small text files.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu.data.local_text import LocalTextDataModule as JaxLocalText
from llmtrain_tpu.data.sampler import DeterministicSampler as JaxSampler
from llmtrain_tpu.data.tokenizers import ByteTokenizer as JaxByteTokenizer
from llmtrain_tpu_torch.config.schemas import RunConfig
from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
from llmtrain_tpu_torch.data.prefetch import BatchPrefetcher
from llmtrain_tpu_torch.data.sampler import DeterministicSampler
from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer, tokenizer_cache_id


@pytest.mark.parametrize(
    "num_examples, batch_size, shuffle",
    [(103, 8, True), (103, 8, False), (5, 8, True)],
    ids=["shuffled", "ordered", "smaller-than-a-batch"],
)
def test_sampler_index_stream_equals_jax(num_examples, batch_size, shuffle) -> None:
    ours = DeterministicSampler(num_examples, batch_size, seed=1337, shuffle=shuffle)
    theirs = JaxSampler(num_examples, batch_size, seed=1337, shuffle=shuffle)
    for b in (0, 1, 11, 12, 13, 40):  # crosses epoch boundaries
        np.testing.assert_array_equal(ours.batch_indices(b), theirs.batch_indices(b))
        assert ours.progress(b) == theirs.progress(b)


def _corpus(tmp_path):
    rng = np.random.default_rng(3)
    words = ["def", "class", "return", "import", "for", "if", "self", "x", "None", "\n"]
    for i in range(5):
        text = " ".join(rng.choice(words, size=300 + 40 * i))
        (tmp_path / f"doc{i}.py").write_text(text)


def _cfg(tmp_path, cache: str, split_documents: bool) -> dict:
    return {
        "run": {"name": "data", "device": "cpu"},
        "model": {"name": "gpt", "block_size": 32, "d_model": 32, "n_layers": 1, "n_heads": 2,
                  "d_ff": 64, "dropout": 0.0, "extra": {"tokenizer": "byte"}},
        "data": {"name": "local_text", "cache_dir": str(tmp_path / cache),
                 "extra": {"globs": [str(tmp_path / "*.py")], "val_fraction": 0.1,
                           "split_documents": split_documents}},
        "trainer": {"max_steps": 1, "warmup_steps": 0},
    }


@pytest.mark.parametrize("split_documents", [False, True], ids=["packed", "segments"])
def test_local_text_windows_equal_jax(tmp_path, split_documents: bool) -> None:
    _corpus(tmp_path)
    ours = LocalTextDataModule()
    ours.setup(RunConfig.model_validate(_cfg(tmp_path, "port", split_documents)), ByteTokenizer())
    theirs = JaxLocalText()
    theirs.setup(JaxRunConfig.model_validate(_cfg(tmp_path, "jax", split_documents)),
                 JaxByteTokenizer())
    for split in ("train_dataset", "val_dataset"):
        a, b = getattr(ours, split)(), getattr(theirs, split)()
        assert len(a) == len(b) > 0
        idx = np.arange(len(a))[::-1]
        got, want = a.get_examples(idx), b.get_examples(idx)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{split}/{key}")
    # The token caches carry the same key, so either package reuses the other's.
    assert sorted(p.name for p in (tmp_path / "port" / "processed").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax" / "processed").iterdir()
    )
    assert tokenizer_cache_id(ByteTokenizer()) == "ByteTokenizer256"


def test_prefetcher_yields_the_synchronous_batches_in_order() -> None:
    def assemble(step: int) -> int:
        return step * 10

    prefetcher = BatchPrefetcher(assemble, depth=2, start_step=3)
    try:
        assert [prefetcher.get(s) for s in (3, 4, 5, 6)] == [30, 40, 50, 60]
    finally:
        prefetcher.close()
    assert prefetcher.closed


def test_prefetcher_reraises_an_assembly_error_at_its_step() -> None:
    def assemble(step: int) -> int:
        if step == 5:
            raise KeyError("bad batch")
        return step

    prefetcher = BatchPrefetcher(assemble, depth=2, start_step=3)
    try:
        assert prefetcher.get(3) == 3 and prefetcher.get(4) == 4
        with pytest.raises(KeyError, match="bad batch"):
            prefetcher.get(5)
    finally:
        prefetcher.close()
