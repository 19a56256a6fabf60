"""Token windows over a flat token stream (``TokenWindowDataset`` of
``llmtrain_tpu/data/hf_text.py``; the rest of that module needs the
``datasets`` package and is not ported).

Windows are non-overlapping ``block_size + 1`` chunks of the stream,
yielding ``input_ids = chunk[:-1]``, ``labels = chunk[1:]`` and an
all-ones ``attention_mask`` (segment ids with ``split_documents``).
"""

from __future__ import annotations

import numpy as np


class TokenWindowDataset:
    """Non-overlapping (block_size+1)-token windows over a flat stream.

    With ``doc_starts`` (sorted document start offsets into the stream)
    and ``split_documents=True``, ``attention_mask`` carries SEGMENT ids
    instead of all-ones: within each window, tokens of the same document
    share one nonzero id (1-based, local to the window), the attention
    paths mask cross-document pairs (equal-id semantics, models/gpt.py
    dense_attention and the Pallas kernels), and positions whose LABEL
    belongs to the next document get mask 0 — a cross-document
    next-token prediction is noise, and as keys those document-final
    tokens serve no same-document query anyway.
    """

    def __init__(
        self,
        tokens: np.ndarray,
        block_size: int,
        *,
        doc_starts: np.ndarray | None = None,
        split_documents: bool = False,
    ) -> None:
        if tokens.ndim != 1:
            raise ValueError(f"token stream must be 1-D, got shape {tokens.shape}")
        if split_documents and doc_starts is None:
            raise ValueError("split_documents=True requires doc_starts")
        self._tokens = tokens
        self._doc_starts = (
            np.asarray(doc_starts, dtype=np.int64) if doc_starts is not None else None
        )
        self._split = bool(split_documents)
        self._block_size = block_size
        self._chunk = block_size + 1
        self._num_windows = len(tokens) // self._chunk

    def __len__(self) -> int:
        return self._num_windows

    def get_examples(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        starts = np.asarray(indices, dtype=np.int64) * self._chunk
        # Gather all windows in one vectorized fancy-index.
        offsets = np.arange(self._chunk, dtype=np.int64)
        positions = starts[:, None] + offsets[None, :]
        chunks = self._tokens[positions]
        input_ids = np.ascontiguousarray(chunks[:, :-1], dtype=np.int32)
        labels = np.ascontiguousarray(chunks[:, 1:], dtype=np.int32)
        if self._split:
            # Document ordinal per position (1-based via 'right'), then
            # renumbered locally so ids stay small per window.
            doc = np.searchsorted(self._doc_starts, positions, side="right")
            seg_in, seg_lab = doc[:, :-1], doc[:, 1:]
            local = seg_in - seg_in.min(axis=1, keepdims=True) + 1
            mask = np.where(seg_in == seg_lab, local, 0).astype(np.int32)
        else:
            mask = np.ones_like(input_ids)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": mask,
        }


__all__ = ["TokenWindowDataset"]
