"""Weighted mixture of local text corpora (port of
``llmtrain_tpu/data/mixed_text.py``).

Pretraining-style corpus mixing: N local corpora, each with a sampling
weight, served as ONE deterministic dataset. Each source is a
full ``local_text`` pipeline (glob → tokenize → window, shared token
caches), so a corpus already cached by a standalone run is reused.

Config::

    data:
      name: "mixed_text"
      extra:
        sources:
          - {globs: ["corpusA/**/*.py"], weight: 3.0}
          - {globs: ["corpusB/**/*.txt"], weight: 1.0, format: "text"}
        # per-source keys: globs (required), weight (default 1.0),
        # val_fraction / format / text_key / split_documents as local_text

The mixture is a pure function of ``run.seed``: window ``i`` of the
epoch draws its source from a seeded categorical over the weights and
its example from that source's stream in order (wrapping around when a
heavily-weighted corpus is smaller than its share). Stateless like
``data/sampler.py``, so multi-process sharding and exact resume need no
extra machinery. Validation is the plain concatenation of the sources'
validation splits — a fixed set, no weighting.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..config.schemas import RunConfig
from ..registry.data import register_data_module
from .base import DataModule, IndexedDataset
from .local_text import LocalTextDataModule

_SOURCE_KEYS = frozenset(
    {"globs", "weight", "val_fraction", "format", "text_key", "split_documents"}
)


class WeightedMixDataset:
    """One epoch over N datasets with per-source sampling weights.

    The source of window ``i`` and its position within that source are
    fixed at construction from ``seed`` — the same (seed, sources) pair
    always yields the same epoch, on every process.

    Slot counts are EXACT (weights realized by construction, not by
    sampling), and the epoch length is ``max_s ceil(size_s / p_s)`` —
    the smallest epoch in which every source is covered in FULL at its
    weight. Under-weighted corpora therefore stretch the epoch rather
    than silently losing their tail, and over-weighted small corpora
    wrap (repeat), the standard mixing semantics. Footprint: 6 bytes
    per slot (int16 source id + int32 ordinal).
    """

    # int32 ordinals + a sane ceiling on how far a tiny weight may
    # stretch the epoch before it is clearly a misconfiguration.
    _MAX_SLOTS = 1 << 31

    def __init__(
        self, datasets: list[Any], weights: list[float], seed: int
    ) -> None:
        sizes = np.asarray([len(d) for d in datasets], dtype=np.float64)
        p = np.asarray(weights, dtype=np.float64)
        p = p / p.sum()
        total = int(np.ceil(sizes / p).max())
        if total >= self._MAX_SLOTS:
            raise ValueError(
                f"mixed_text epoch needs {total:,} slots to cover every "
                "source at these weights — rebalance the weights or shrink "
                "the under-weighted corpus"
            )
        # Exact per-source slot counts: floor shares, largest-remainder
        # rounding, then a full-coverage floor.
        shares = np.floor(p * total).astype(np.int64)
        remainder = p * total - shares
        for _ in range(total - int(shares.sum())):
            k = int(np.argmax(remainder))
            shares[k] += 1
            remainder[k] = -1.0
        # Full-coverage floor LAST (share >= size holds by the epoch
        # formula; rounding must not dip below it). The epoch absorbs the
        # <= n_sources extra slots instead of truncating a source's tail.
        shares = np.maximum(shares, sizes.astype(np.int64))
        self._datasets = datasets
        slots = np.repeat(np.arange(len(datasets), dtype=np.int16), shares)
        rng = np.random.default_rng(seed)
        self._src = rng.permutation(slots)
        # Occurrence ordinal: the j-th window drawn from source s reads
        # that source's j-th example (mod its size).
        self._ord = np.empty(len(self._src), dtype=np.int32)
        for s in range(len(datasets)):
            mask = self._src == s
            self._ord[mask] = np.arange(int(mask.sum()), dtype=np.int32)

    def __len__(self) -> int:
        return len(self._src)

    def source_histogram(self) -> np.ndarray:
        """Windows drawn per source over the epoch (for tests/logs)."""
        return np.bincount(self._src, minlength=len(self._datasets))

    def get_examples(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        indices = np.asarray(indices, dtype=np.int64)
        src = self._src[indices]
        out: dict[str, np.ndarray] | None = None
        for s in np.unique(src):
            rows = np.nonzero(src == s)[0]
            ds = self._datasets[int(s)]
            local = self._ord[indices[rows]] % len(ds)
            examples = ds.get_examples(local)
            if out is None:
                out = {
                    k: np.empty((len(indices),) + v.shape[1:], dtype=v.dtype)
                    for k, v in examples.items()
                }
            if set(examples) != set(out):
                raise ValueError(
                    f"mixed_text sources emit different batch keys: "
                    f"{sorted(out)} vs {sorted(examples)} — use the same "
                    "split_documents setting on every source"
                )
            for k, v in examples.items():
                out[k][rows] = v
        assert out is not None  # indices is never empty in practice
        return out


class ConcatDataset:
    """Plain concatenation of datasets (the mixture's validation set)."""

    def __init__(self, datasets: list[Any]) -> None:
        self._datasets = datasets
        sizes = np.asarray([len(d) for d in datasets], dtype=np.int64)
        self._starts = np.concatenate([[0], np.cumsum(sizes)])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def get_examples(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        indices = np.asarray(indices, dtype=np.int64)
        which = np.searchsorted(self._starts, indices, side="right") - 1
        out: dict[str, np.ndarray] | None = None
        for s in np.unique(which):
            rows = np.nonzero(which == s)[0]
            local = indices[rows] - self._starts[s]
            examples = self._datasets[int(s)].get_examples(local)
            if out is None:
                out = {
                    k: np.empty((len(indices),) + v.shape[1:], dtype=v.dtype)
                    for k, v in examples.items()
                }
            for k, v in examples.items():
                out[k][rows] = v
        assert out is not None
        return out


@register_data_module("mixed_text")
class MixedTextDataModule(DataModule):
    """Weighted mixture of ``local_text`` corpora as one dataset."""

    known_extra_keys = frozenset({"sources"})

    def __init__(self) -> None:
        self._train: WeightedMixDataset | None = None
        self._val: ConcatDataset | None = None

    def setup(self, cfg: RunConfig, tokenizer: Any | None = None) -> None:
        sources = cfg.data.extra.get("sources")
        if not isinstance(sources, (list, tuple)) or not sources:
            raise ValueError(
                "mixed_text requires data.extra.sources: a non-empty list of "
                "{globs, weight, ...} mappings"
            )
        # Config-only validation FIRST: a disagreement must fail in
        # milliseconds, not after tokenizing multi-GB corpora.
        split_settings: set[bool] = set()
        for i, source in enumerate(sources):
            if not isinstance(source, dict):
                raise ValueError(f"mixed_text source #{i} must be a mapping")
            unknown = sorted(set(source) - _SOURCE_KEYS)
            if unknown:
                raise ValueError(
                    f"mixed_text source #{i}: unknown keys {unknown}; "
                    f"expected {sorted(_SOURCE_KEYS)}"
                )
            if float(source.get("weight", 1.0)) <= 0:
                raise ValueError(
                    f"mixed_text source #{i}: weight must be > 0, got "
                    f"{source.get('weight')}"
                )
            split_settings.add(bool(source.get("split_documents", False)))
        if len(split_settings) > 1:
            raise ValueError(
                "mixed_text sources must agree on split_documents: mixing "
                "segment-masked and unmasked windows in one batch is invalid"
            )

        trains: list[Any] = []
        vals: list[Any] = []
        weights: list[float] = []
        for i, source in enumerate(sources):
            weight = float(source.get("weight", 1.0))
            # Each source IS a local_text pipeline over a synthesized
            # config — same validation, same token caches.
            raw = cfg.model_dump()
            raw["data"]["name"] = "local_text"
            raw["data"]["extra"] = {
                k: v for k, v in source.items() if k != "weight"
            }
            sub_cfg = RunConfig.model_validate(raw)
            sub = LocalTextDataModule()
            try:
                sub.setup(sub_cfg, tokenizer)
            except ValueError as exc:
                raise ValueError(f"mixed_text source #{i}: {exc}") from exc
            trains.append(sub.train_dataset())
            if sub.val_dataset() is not None:
                vals.append(sub.val_dataset())
            weights.append(weight)
        self._train = WeightedMixDataset(trains, weights, cfg.run.seed)
        self._val = ConcatDataset(vals) if vals else None

    def train_dataset(self) -> IndexedDataset:
        if self._train is None:
            raise RuntimeError("setup must be called before train_dataset")
        return self._train

    def val_dataset(self) -> IndexedDataset | None:
        if self._train is None:
            raise RuntimeError("setup must be called before val_dataset")
        return self._val


__all__ = ["ConcatDataset", "MixedTextDataModule", "WeightedMixDataset"]
