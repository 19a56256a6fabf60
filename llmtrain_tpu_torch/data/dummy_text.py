"""Synthetic text data module, the fast fake data backend for tests and
the smoke presets (port of ``llmtrain_tpu/data/dummy_text.py``).

Per-index seeded random tokens with labels = a copy of the inputs; caps
seq_len <= 8, examples <= 128, val = num/5 capped at 32, val seed =
seed + 1000. Each example comes from ``np.random.default_rng(seed +
index)``, so the port and the JAX package serve the same tokens.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..config.schemas import RunConfig
from ..registry.data import register_data_module
from .base import DataModule, IndexedDataset


class _DummyTextDataset:
    """Each example is a deterministic function of (seed, index)."""

    def __init__(
        self,
        num_examples: int,
        seq_len: int,
        vocab_size: int,
        deterministic: bool,
        seed: int,
    ) -> None:
        self._num_examples = num_examples
        self._seq_len = seq_len
        self._vocab_size = vocab_size
        self._deterministic = deterministic
        self._seed = seed

    def __len__(self) -> int:
        return self._num_examples

    def get_examples(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        batch = np.empty((len(indices), self._seq_len), dtype=np.int32)
        for row, index in enumerate(indices):
            seed = self._seed + int(index) if self._deterministic else None
            rng = np.random.default_rng(seed)
            batch[row] = rng.integers(0, self._vocab_size, size=self._seq_len, dtype=np.int32)
        return {
            "input_ids": batch,
            "labels": batch.copy(),
            "attention_mask": np.ones_like(batch),
        }


@register_data_module("dummy_text")
class DummyTextDataModule(DataModule):
    """Synthetic text data for dry-run smoke tests."""

    known_extra_keys = frozenset()

    def __init__(self) -> None:
        self._train: _DummyTextDataset | None = None
        self._val: _DummyTextDataset | None = None

    def setup(self, cfg: RunConfig, tokenizer: Any | None = None) -> None:
        del tokenizer
        vocab_size = cfg.model.vocab_size or 128
        # Keep synthetic batches tiny so unit tests are fast and stable.
        seq_len = max(2, min(cfg.model.block_size, 8))
        requested = cfg.trainer.max_steps * cfg.trainer.micro_batch_size
        num_examples = max(1, min(requested, 128))
        self._train = _DummyTextDataset(
            num_examples=num_examples,
            seq_len=seq_len,
            vocab_size=vocab_size,
            deterministic=cfg.run.deterministic,
            seed=cfg.run.seed,
        )
        val_examples = max(1, min(num_examples // 5, 32))
        self._val = _DummyTextDataset(
            num_examples=val_examples,
            seq_len=seq_len,
            vocab_size=vocab_size,
            deterministic=cfg.run.deterministic,
            seed=cfg.run.seed + 1000,
        )

    def train_dataset(self) -> IndexedDataset:
        if self._train is None:
            raise RuntimeError("setup must be called before train_dataset")
        return self._train

    def val_dataset(self) -> IndexedDataset | None:
        if self._val is None:
            raise RuntimeError("setup must be called before val_dataset")
        return self._val


__all__ = ["DummyTextDataModule", "_DummyTextDataset"]
