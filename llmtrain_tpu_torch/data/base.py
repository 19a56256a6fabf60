"""Data-module plugin contract (port of ``llmtrain_tpu/data/base.py``;
this module imports no JAX there, so the port keeps its own copy).

The design replaces stateful torch DataLoaders + DistributedSampler with
*indexable datasets*:
``setup`` prepares arrays, ``train_dataset``/``val_dataset`` return objects
supporting random access by example index. Batch order, sharding across
processes, and resume position are then pure functions of (seed, step) —
see ``llmtrain_tpu.data.sampler`` — which is what makes bitwise resume and
multi-host determinism possible without the reference's single-process
skip-ahead hack (reference trainer.py:336-347).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Protocol, runtime_checkable

import numpy as np

from ..config.schemas import RunConfig


@runtime_checkable
class IndexedDataset(Protocol):
    """Random-access dataset of fixed-shape tokenized examples."""

    def __len__(self) -> int: ...

    def get_examples(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        """Gather a batch: each value has leading dim ``len(indices)``."""
        ...


class DataModule(ABC):
    """Prepares train/val datasets for a run."""

    # Extra-dict keys this module understands (config/extras.py warns on
    # others); None disables the check.
    known_extra_keys: frozenset[str] | None = None

    @abstractmethod
    def setup(self, cfg: RunConfig, tokenizer: Any | None) -> None:
        """Load/tokenize/cache data. Called once before training."""

    @abstractmethod
    def train_dataset(self) -> IndexedDataset:
        """The training split (must be non-empty)."""

    @abstractmethod
    def val_dataset(self) -> IndexedDataset | None:
        """The validation split, or None if the module has no val data."""


def load_token_cache(cache_path, *, need_docs: bool):
    """Read a flat-token cache + its ``.docs.npy`` sidecar (doc starts).

    Returns ``(tokens, doc_starts_or_None)`` on a hit, ``None`` on a miss.
    Raises when ``need_docs`` but the sidecar is absent — an old cache
    from before ``split_documents`` existed must be rebuilt. Shared by
    hf_text and local_text so the protocol (and its failure text) cannot
    drift.
    """
    import numpy as np

    if not cache_path.exists():
        return None
    tokens = np.load(cache_path, mmap_mode="r")
    docs_path = cache_path.with_suffix(".docs.npy")
    if not need_docs:
        return tokens, None
    if docs_path.exists():
        return tokens, np.load(docs_path)
    raise ValueError(
        f"token cache {cache_path} predates document offsets "
        "(data.extra.split_documents); delete it to rebuild"
    )


def write_token_cache(cache_path, tokens, doc_starts) -> None:
    """Atomically publish tokens + doc-starts sidecar.

    The SIDECAR is published first: a concurrent rank (or a crash
    between the two renames) must never observe tokens-without-sidecar,
    which ``load_token_cache`` treats as a stale pre-split_documents
    cache. Per-process tmp names keep concurrent cold-cache builders off
    each other's files.
    """
    import os

    import numpy as np

    cache_path.parent.mkdir(parents=True, exist_ok=True)
    docs_path = cache_path.with_suffix(".docs.npy")
    tmp_docs = docs_path.with_suffix(f".tmp{os.getpid()}.npy")
    np.save(tmp_docs, doc_starts)
    tmp_docs.replace(docs_path)
    tmp = cache_path.with_suffix(f".tmp{os.getpid()}.npy")
    np.save(tmp, tokens)
    tmp.replace(cache_path)


def validate_split_documents(cfg: RunConfig) -> None:
    """Config combinations ``split_documents`` cannot serve, failed loudly.

    Ring/Ulysses are fine: segment masks ride both sequence-parallel
    schemes (the ring rotates key segments with their K/V shards and
    keeps the unrotated local shard as the query segments;
    tests/test_ops.py::TestSequenceParallelMasks pins parity).
    """
    if cfg.model.extra.get("assume_packed"):
        raise ValueError(
            "data.extra.split_documents emits segment masks, but "
            "model.extra.assume_packed drops the mask operand — the "
            "cross-document masking would be silently lost; unset one"
        )
