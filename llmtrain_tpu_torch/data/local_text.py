"""Local-filesystem text data module: glob → read → tokenize → window
(port of ``llmtrain_tpu/data/local_text.py``).

Fully offline counterpart of ``hf_text`` (same flat-stream token cache and
``TokenWindowDataset`` windows; reference behavior spec at
src/llmtrain/data/hf_text.py:108-174): instead of a HuggingFace dataset it
concatenates the text of local files matched by glob patterns, so training
works with zero network egress — e.g. on a source-code corpus.

Config::

    data:
      name: "local_text"
      extra:
        globs: ["/usr/local/lib/python3.12/**/*.py"]
        val_fraction: 0.01   # tail of the token stream held out for eval
        format: "text"       # or "jsonl": one JSON object per line,
        text_key: "text"     #   text under this key (jsonl only)

Train/val are a deterministic head/tail split of the single token stream
(files sorted lexicographically), so the split is stable across runs and
processes.
"""

from __future__ import annotations

import glob
import hashlib
from pathlib import Path
from typing import Any

import numpy as np

from ..config.schemas import RunConfig
from ..registry.data import register_data_module
from .base import (
    DataModule,
    IndexedDataset,
    load_token_cache,
    validate_split_documents,
    write_token_cache,
)
from .hf_text import TokenWindowDataset

_DEFAULT_VAL_FRACTION = 0.01


@register_data_module("local_text")
class LocalTextDataModule(DataModule):
    """Serves fixed token windows over a corpus of local text files."""

    known_extra_keys = frozenset(
        {"globs", "val_fraction", "format", "text_key", "split_documents"}
    )

    def __init__(self) -> None:
        self._train: TokenWindowDataset | None = None
        self._val: TokenWindowDataset | None = None

    def setup(self, cfg: RunConfig, tokenizer: Any | None = None) -> None:
        if tokenizer is None:
            raise ValueError("local_text requires a tokenizer from the model adapter")
        globs = cfg.data.extra.get("globs")
        if not globs or not isinstance(globs, (list, tuple)):
            raise ValueError("local_text requires data.extra.globs (list of glob patterns)")
        val_fraction = float(cfg.data.extra.get("val_fraction", _DEFAULT_VAL_FRACTION))
        if not 0.0 <= val_fraction < 1.0:
            raise ValueError(f"val_fraction must be in [0, 1), got {val_fraction}")
        fmt = cfg.data.extra.get("format", "text")
        if fmt not in ("text", "jsonl"):
            raise ValueError(f"local_text format must be 'text' or 'jsonl', got {fmt!r}")

        files = sorted({f for pattern in globs for f in glob.glob(pattern, recursive=True)})
        files = [f for f in files if Path(f).is_file()]
        if not files:
            raise ValueError(f"local_text globs matched no files: {globs}")

        split_docs = bool(cfg.data.extra.get("split_documents", False))
        if split_docs:
            validate_split_documents(cfg)
        tokens, doc_starts = self._load_or_build_cache(
            cfg, files, tokenizer, fmt=fmt, need_docs=split_docs
        )
        n_train = len(tokens) - int(len(tokens) * val_fraction)
        train_tokens, val_tokens = tokens[:n_train], tokens[n_train:]
        train_docs = val_docs = None
        if split_docs:
            train_docs = doc_starts[doc_starts < n_train]
            # The val stream may open mid-document; positions before its
            # first boundary get ordinal 0, made 1-based by the window's
            # local renumbering.
            val_docs = doc_starts[doc_starts >= n_train] - n_train

        self._train = TokenWindowDataset(
            train_tokens, cfg.model.block_size,
            doc_starts=train_docs, split_documents=split_docs,
        )
        if len(self._train) == 0:
            raise ValueError(
                f"corpus too small: {len(train_tokens)} train tokens for "
                f"block_size {cfg.model.block_size}"
            )
        val_ds = TokenWindowDataset(
            val_tokens, cfg.model.block_size,
            doc_starts=val_docs, split_documents=split_docs,
        )
        self._val = val_ds if len(val_ds) > 0 else None

    def _load_or_build_cache(
        self, cfg: RunConfig, files: list[str], tokenizer: Any, *,
        fmt: str = "text", need_docs: bool = False,
    ) -> tuple[np.ndarray, np.ndarray | None]:
        text_key = str(cfg.data.extra.get("text_key", "text"))
        # Key by file list + size + mtime (size alone misses equal-length
        # edits) + parse mode + tokenizer identity — token ids from a
        # different tokenizer would silently corrupt training (hf_text's
        # cache rule).
        h = hashlib.sha256()
        # text_key only matters in jsonl mode; hashing it in text mode would
        # invalidate the cache on an irrelevant config change. The "r2"
        # marker versions the jsonl ingestion: per-RECORD encoding (for
        # document boundaries) can merge BPE tokens differently than the
        # old joined-text encode, so pre-change jsonl caches must not be
        # silently reused. Text-mode streams are unchanged — no bump.
        h.update(f"{fmt}:{text_key + ':r2' if fmt == 'jsonl' else ''};".encode())
        for f in files:
            st = Path(f).stat()
            h.update(f.encode())
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        from .tokenizers import tokenizer_cache_id

        tok_id = tokenizer_cache_id(tokenizer)
        cache_path = (
            Path(cfg.data.cache_dir) / "processed" / f"local__{h.hexdigest()[:16]}__{tok_id}.npy"
        )
        cached = load_token_cache(cache_path, need_docs=need_docs)
        if cached is not None:
            return cached

        encode_np = getattr(tokenizer, "encode_np", None)
        sep = np.asarray(tokenizer.encode("\n\n"), dtype=np.int32)
        pieces: list[np.ndarray] = []
        doc_starts: list[int] = []
        total = 0
        for f in files:
            raw = Path(f).read_text(encoding="utf-8", errors="ignore")
            # Document granularity: the whole file in text mode, one JSON
            # record in jsonl mode — so split_documents boundaries match
            # what a reader would call a document, not the file layout.
            for text in self._extract_documents(f, raw, fmt, text_key):
                if not text:
                    continue
                if encode_np is not None:
                    ids = encode_np(text)
                else:
                    ids = np.asarray(tokenizer.encode(text), dtype=np.int32)
                if ids.size:
                    # The boundary marker belongs to the document it
                    # follows: newline keeps documents separated without
                    # inventing an out-of-vocab separator id.
                    doc_starts.append(total)
                    pieces.append(ids)
                    pieces.append(sep)
                    total += ids.size + sep.size
        tokens = (
            np.concatenate(pieces).astype(np.int32)
            if pieces
            else np.zeros((0,), dtype=np.int32)
        )
        starts_arr = np.asarray(doc_starts, dtype=np.int64)
        write_token_cache(cache_path, tokens, starts_arr)
        return tokens, (starts_arr if need_docs else None)

    @staticmethod
    def _extract_documents(
        path: str, raw: str, fmt: str, text_key: str
    ) -> list[str]:
        """Raw file content → list of document texts. "text" yields the
        whole file as one document; "jsonl" parses one JSON object per
        line and yields each ``text_key`` field as its own document (so
        ``split_documents`` boundaries are per record, not per file)."""
        if fmt == "text":
            return [raw]
        import json

        docs: list[str] = []
        # split("\n"), not splitlines(): the latter also splits on U+2028/
        # U+2029/U+0085, which are legal unescaped inside JSON strings
        # (ensure_ascii=False corpora), and would shear valid objects apart.
        for lineno, line in enumerate(raw.split("\n"), start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: invalid JSON line: {exc}") from exc
            val = obj.get(text_key) if isinstance(obj, dict) else None
            if not isinstance(val, str):
                raise ValueError(
                    f"{path}:{lineno}: expected a string field {text_key!r} "
                    f"in each JSONL object"
                )
            docs.append(val)
        return docs

    def train_dataset(self) -> IndexedDataset:
        if self._train is None:
            raise RuntimeError("setup must be called before train_dataset")
        return self._train

    def val_dataset(self) -> IndexedDataset | None:
        if self._train is None:
            raise RuntimeError("setup must be called before val_dataset")
        return self._val


__all__ = ["LocalTextDataModule"]
