"""Deterministic, stateless batch sampling (port of
``llmtrain_tpu/data/sampler.py``, numpy only: the same index stream).

Replaces the reference's ``DistributedSampler`` + epoch iteration
(reference data/hf_text.py:182-198) and its resume-by-replay batch skipping
(reference trainer.py:336-347, explicitly unsafe under DDP) with a pure
function: the examples making up global micro-batch ``b`` are a function of
``(seed, b)`` only. Every process computes the same global index list and
slices out its own shard, so resume and multi-host sharding are exact by
construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _epoch_permutation(num_examples: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(epoch,)))
    return rng.permutation(num_examples)


@dataclass(frozen=True)
class DeterministicSampler:
    """Maps a global micro-batch index to example indices.

    ``batch_size`` is the *global* micro-batch size (per-replica batch ×
    data-parallel degree). Incomplete trailing batches are dropped, matching
    torch DataLoader ``drop_last`` semantics for stable shapes under jit.
    """

    num_examples: int
    batch_size: int
    seed: int
    shuffle: bool = True

    def __post_init__(self) -> None:
        if self.num_examples < 1:
            raise ValueError("dataset has no examples")

    @property
    def batches_per_epoch(self) -> int:
        return max(1, self.num_examples // self.batch_size)

    def batch_indices(self, batch_index: int) -> np.ndarray:
        """Example indices of global micro-batch ``batch_index`` (0-based).

        Datasets smaller than one global micro-batch (tiny smoke datasets ×
        wide data-parallel meshes) wrap deterministically: the epoch
        permutation is tiled until the batch is full.
        """
        epoch, pos = divmod(batch_index, self.batches_per_epoch)
        if self.shuffle:
            perm = _epoch_permutation(self.num_examples, self.seed, epoch)
        else:
            perm = np.arange(self.num_examples)
        if self.num_examples < self.batch_size:
            reps = -(-self.batch_size // self.num_examples)
            perm = np.tile(perm, reps)
        return perm[pos * self.batch_size : (pos + 1) * self.batch_size]

    def progress(self, batch_index: int) -> dict:
        """Resumable progress record for global micro-batch ``batch_index``
        (the NEXT batch to consume). The sampler is stateless, so this is
        the entire "sampler state" a checkpoint manifest needs: the resumed
        run re-derives identical batches from (seed, index) alone — on any
        data-parallel world size, since sharding happens after the global
        indices are fixed (see ``resilience/elastic.py``)."""
        epoch, pos = divmod(batch_index, self.batches_per_epoch)
        return {
            "seed": int(self.seed),
            "global_micro_batch": int(self.batch_size),
            "consumed_micro_batches": int(batch_index),
            "epoch": int(epoch),
            "position_in_epoch": int(pos),
            "consumed_examples": int(batch_index) * int(self.batch_size),
            "shuffle": bool(self.shuffle),
        }

    def shard_indices(self, batch_index: int, shard: int, num_shards: int) -> np.ndarray:
        """This process's contiguous slice of the global batch.

        Slicing is contiguous (not strided) so the host slice matches the
        ``data``-axis sharding layout of the global device array.
        """
        if self.batch_size % num_shards != 0:
            raise ValueError(
                f"global micro-batch {self.batch_size} not divisible by {num_shards} shards"
            )
        per_shard = self.batch_size // num_shards
        full = self.batch_indices(batch_index)
        return full[shard * per_shard : (shard + 1) * per_shard]
