"""Offline tokenizers (port of ``llmtrain_tpu/data/tokenizers.py``).

The byte-level tokenizer (``model.extra.tokenizer: "byte"``: 256-symbol
vocabulary, UTF-8 bytes as token ids) and ``bpe:<path>``, a vocabulary
trained offline by ``train-tokenizer`` (data/bpe.py). ``gpt2`` needs
tiktoken's downloaded BPE files and raises here as it would offline;
``hf:<tokenizer.json>`` needs the ``tokenizers`` package, which the card's
machine lacks, and is refused (ROADMAP.md queue A: model zoo, beside the
HF-Llama interop it serves).
"""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: token id == byte value, vocab 256."""

    n_vocab = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def encode_np(self, text: str) -> np.ndarray:
        """Vectorized encode, the fast path for corpus preprocessing."""
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        arr = np.asarray(ids, dtype=np.int64)
        if arr.size and (arr.min() < 0 or arr.max() > 255):
            raise ValueError("byte tokenizer ids must be in [0, 255]")
        return bytes(arr.astype(np.uint8).tolist()).decode("utf-8", errors="replace")


def build_tokenizer(name: str):
    """Resolve a tokenizer by config name: ``"byte"`` and ``"bpe:<path>"``;
    ``"gpt2"`` raises (its BPE files need a download); ``"hf:"`` raises as
    not yet ported; anything else is unknown."""
    if name == "byte":
        return ByteTokenizer()
    if name == "gpt2":
        raise RuntimeError(
            "the gpt2 tokenizer needs tiktoken's BPE files, which are "
            "downloaded on first use; use model.extra.tokenizer: \"byte\" "
            "or set model.vocab_size and pass prompt ids"
        )
    if name.startswith("bpe:"):
        from .bpe import BPETokenizer

        return BPETokenizer.load(name[len("bpe:"):])
    if name.startswith("hf:"):
        raise NotImplementedError(
            f"tokenizer {name!r} is not yet ported to llmtrain_tpu_torch: it needs "
            "the tokenizers package (ROADMAP.md queue A: model zoo); use \"byte\" "
            "or \"bpe:<path>\""
        )
    raise ValueError(
        f"unknown tokenizer {name!r}; expected 'gpt2', 'byte', 'bpe:<path>', "
        "or 'hf:<tokenizer.json>'"
    )


def tokenizer_cache_id(tokenizer) -> str:
    """Identity string for token-cache keys (data/local_text.py): class,
    vocab size and content fingerprint, as in JAX, so a cache built by
    either package for the same tokenizer is the same file."""
    return (
        f"{type(tokenizer).__name__}{getattr(tokenizer, 'n_vocab', 'x')}"
        f"{getattr(tokenizer, 'fingerprint', '')}"
    )


__all__ = ["ByteTokenizer", "build_tokenizer", "tokenizer_cache_id"]
