"""Offline-trainable byte-level BPE tokenizer (port of
``llmtrain_tpu/data/bpe.py``).

Train a byte-level BPE on the local corpus itself and use it through the
tokenizer interface (``n_vocab``, ``encode``/``encode_np``/``decode``,
``eot_token``, ``fingerprint``). The vocabulary file is JAX's JSON format
(``"format": "llmtrain-bpe"``, version 1), so either package reads the
other's, and the same corpus trains the same file byte for byte.

Construction is the standard byte-level BPE: start from the 256 byte
symbols, repeatedly merge the most frequent adjacent pair within
pre-tokens, ties toward the smallest pair. Pre-tokenization is a
simplified gpt2-style split (a leading space binds to the following
word), NOT merge-compatible with tiktoken's gpt2 vocabulary.

Encoding memoizes words; cold words go through the native C encoder
(llmtrain_tpu_torch/native) when it builds, else the Python loop, with the
same ids either way.

Usage:
    python -m llmtrain_tpu_torch train-tokenizer --input corpus/ \
        --vocab-size 8192 --output tok8k.json
    # then in the run config:
    model:
      extra: {tokenizer: "bpe:tok8k.json"}
"""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

# Leading space binds to the word that follows (gpt2-style), so merges can
# learn " the"-like units; runs of other whitespace stay separate tokens.
_PRETOKEN_RE = re.compile(r" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+")

_EOT = "<|endoftext|>"


def _merge(ids: list[int], pair: tuple[int, int], new_id: int) -> list[int]:
    """Replace every non-overlapping occurrence of ``pair`` (left to right)."""
    out: list[int] = []
    i, n = 0, len(ids)
    a, b = pair
    while i < n:
        if i + 1 < n and ids[i] == a and ids[i + 1] == b:
            out.append(new_id)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


def train_bpe(
    text: str,
    vocab_size: int,
    *,
    special_tokens: tuple[str, ...] = (_EOT,),
) -> "BPETokenizer":
    """Learn ``vocab_size - 256 - len(special_tokens)`` merges from ``text``.

    Deterministic: ties in pair frequency break toward the numerically
    smallest pair, so the same corpus always yields the same vocabulary.
    Stops early if no pair occurs at least twice.
    """
    n_merges = vocab_size - 256 - len(special_tokens)
    if n_merges < 0:
        raise ValueError(
            f"vocab_size {vocab_size} too small: need >= {256 + len(special_tokens)}"
        )

    word_counts = Counter(_PRETOKEN_RE.findall(text))
    words: list[tuple[list[int], int]] = [
        (list(w.encode("utf-8")), c) for w, c in word_counts.items()
    ]

    pair_counts: dict[tuple[int, int], int] = defaultdict(int)
    pair_words: dict[tuple[int, int], set[int]] = defaultdict(set)
    for wi, (ids, c) in enumerate(words):
        for p in zip(ids, ids[1:]):
            pair_counts[p] += c
            pair_words[p].add(wi)

    merges: list[tuple[int, int]] = []
    for new_id in range(256, 256 + n_merges):
        if not pair_counts:
            break
        best = max(pair_counts.items(), key=lambda kv: (kv[1], -kv[0][0], -kv[0][1]))
        pair, count = best
        if count < 2:
            break
        merges.append(pair)
        # Only words that (may) contain the pair change; update their pair
        # contributions in place. pair_words sets may hold stale indices
        # (a word that lost the pair in an earlier merge) — harmless, the
        # re-count below is driven by the word's actual ids.
        for wi in list(pair_words.pop(pair, ())):
            ids, c = words[wi]
            for p in zip(ids, ids[1:]):
                pair_counts[p] -= c
                if pair_counts[p] <= 0:
                    del pair_counts[p]
            new_ids = _merge(ids, pair, new_id)
            words[wi] = (new_ids, c)
            for p in zip(new_ids, new_ids[1:]):
                pair_counts[p] = pair_counts.get(p, 0) + c
                pair_words[p].add(wi)
        pair_counts.pop(pair, None)

    return BPETokenizer(merges, special_tokens=special_tokens)


class BPETokenizer:
    """Byte-level BPE with the repo's tokenizer interface.

    ids: ``[0, 256)`` raw bytes, ``[256, 256+len(merges))`` merged units in
    rank order, then special tokens. ``encode`` never emits specials (the
    pre-tokenizer cannot produce them); they exist for ``eot_token``
    plumbing (generation.py early-stop) and decode.
    """

    def __init__(
        self,
        merges: list[tuple[int, int]],
        *,
        special_tokens: tuple[str, ...] = (_EOT,),
    ) -> None:
        self._merges = [tuple(m) for m in merges]
        self._rank = {p: r for r, p in enumerate(self._merges)}
        self._special = tuple(special_tokens)
        vocab: list[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self._merges:
            vocab.append(vocab[a] + vocab[b])
        self._vocab = vocab
        self.n_vocab = 256 + len(self._merges) + len(self._special)
        self._cache: dict[str, list[int]] = {}
        # Native cold-word encoder (llmtrain_tpu_torch/native, C via
        # ctypes); None on hosts without a C compiler or under
        # LLMTRAIN_NO_NATIVE=1 — the Python loop below is the correctness
        # reference either way.
        from ..native import fastbpe_encoder

        self._native = fastbpe_encoder(self._merges)

    @property
    def encoder(self) -> str:
        """Which cold-word encoder runs: ``"native"`` or ``"python"``."""
        return "python" if self._native is None else "native"

    # -- tiktoken-compatible surface ------------------------------------
    @property
    def eot_token(self) -> int | None:
        if _EOT in self._special:
            return 256 + len(self._merges) + self._special.index(_EOT)
        return None

    @property
    def fingerprint(self) -> str:
        """Distinguishes same-size vocabularies in data caches."""
        import hashlib

        h = hashlib.sha256()
        for a, b in self._merges:
            h.update(f"{a},{b};".encode())
        h.update("|".join(self._special).encode())
        return h.hexdigest()[:12]

    def _encode_word(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self._native is not None:
            ids = self._native.encode_word(word)
        else:
            ids = list(word.encode("utf-8"))
            while len(ids) >= 2:
                ranked = [
                    (r, i)
                    for i, p in enumerate(zip(ids, ids[1:]))
                    if (r := self._rank.get(p)) is not None
                ]
                if not ranked:
                    break
                rank, _ = min(ranked)
                ids = _merge(ids, self._merges[rank], 256 + rank)
        if len(self._cache) < 1_000_000:
            self._cache[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for word in _PRETOKEN_RE.findall(text):
            out.extend(self._encode_word(word))
        return out

    def encode_np(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), dtype=np.int32)

    def decode(self, ids) -> str:
        pieces: list[bytes] = []
        base = 256 + len(self._merges)
        for i in np.asarray(ids, dtype=np.int64).tolist():
            if 0 <= i < base:
                pieces.append(self._vocab[i])
            elif base <= i < self.n_vocab:
                pieces.append(self._special[i - base].encode("utf-8"))
            else:
                raise ValueError(f"token id {i} out of range [0, {self.n_vocab})")
        return b"".join(pieces).decode("utf-8", errors="replace")

    # -- persistence -----------------------------------------------------
    def save(self, path: str | Path) -> None:
        payload = {
            "format": "llmtrain-bpe",
            "version": 1,
            "merges": [list(m) for m in self._merges],
            "special_tokens": list(self._special),
        }
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(p)

    @classmethod
    def load(cls, path: str | Path) -> "BPETokenizer":
        payload = json.loads(Path(path).read_text())
        if payload.get("format") != "llmtrain-bpe" or payload.get("version") != 1:
            raise ValueError(f"{path}: not a llmtrain-bpe v1 vocabulary file")
        return cls(
            [tuple(m) for m in payload["merges"]],
            special_tokens=tuple(payload["special_tokens"]),
        )


__all__ = ["BPETokenizer", "train_bpe"]
