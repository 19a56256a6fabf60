"""Blockwise (memory-efficient) causal attention in plain PyTorch (port of
``llmtrain_tpu/ops/blockwise_attention.py``; JAX's is plain XLA too, and
reaches no Pallas kernel).

Exact attention by an online softmax over key/value chunks, so no (T, T)
score matrix is kept: the forward keeps each query row's running max and
sum, and the backward (:class:`_Blockwise`) recomputes every block's
probabilities from the saved row max and sum, as JAX's checkpointed scan
body does. The same block functions serve ring attention
(ops/ring_attention.py), whose shards are chunks of a longer sequence:

* ``q_offset``/``kv_offset`` are the absolute positions of the first
  query and key, so the causal mask holds on chunks of a longer sequence;
* grouped-query K/V (``Hkv`` dividing ``H``) is consumed narrow;
* ``key_mask`` (B, Tk) is a padding mask (nonzero attends); with
  ``query_mask`` (B, Tq) both become segment ids: a key is live for a
  query of the same nonzero segment only;
* ``window`` > 0 keeps each query's trailing ``window`` keys.

A masked score is -1e30, not -inf, as in JAX: a row whose keys are all
dead averages the values it was shown, with the same bits in both
frameworks, and the backward repeats it from the saved max and sum.
Without a key mask, a key chunk wholly past a causal query chunk adds
exactly nothing (its probabilities are exp(-1e30 - max) = 0) and is
skipped.
"""

from __future__ import annotations

import math
from typing import Any

import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Tq, H, Tk) f32 scores of q (B, Tq, H, D) against narrow k
    (B, Tk, Hkv, D): the product in the input dtype, times the scale,
    then f32 (JAX's order)."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    if h != hkv:
        g = h // hkv
        s = torch.einsum("bqkgd,bskd->bqkgs", q.reshape(b, tq, hkv, g, d), k)
        s = s.reshape(b, tq, h, k.shape[1])
    else:
        s = torch.einsum("bqhd,bkhd->bqhk", q, k)
    return (s * scale).float()


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, Tq, H, D) f32 of probabilities (B, Tq, H, Tk) against narrow v."""
    b, tq, h, tk = p.shape
    hkv, d = v.shape[2], v.shape[3]
    if h != hkv:
        g = h // hkv
        out = torch.einsum("bqkgs,bskd->bqkgd", p.reshape(b, tq, hkv, g, tk), v)
        return out.reshape(b, tq, h, d).float()
    return torch.einsum("bqhk,bkhd->bqhd", p, v).float()


def _live(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window: int,
          m_c: torch.Tensor | None, q_seg: torch.Tensor | None,
          k_seg: torch.Tensor | None) -> torch.Tensor | None:
    """The live-score mask of one block, broadcastable to (B, Tq, H, Tk),
    or None when every score is live."""
    live = None
    if causal:
        live = q_pos[:, None] >= k_pos[None, :]
        if window:
            live = live & (q_pos[:, None] - k_pos[None, :] < window)
        live = live[None, :, None, :]
    if m_c is not None:
        keys = (m_c != 0)[:, None, None, :]
        if q_seg is not None:
            keys = keys & (q_seg[:, :, None, None] == k_seg[:, None, None, :])
        live = keys if live is None else live & keys
    return live


def _dead(q0: int, tq: int, k0: int, *, causal: bool, masked: bool) -> bool:
    """True when a key block starting at ``k0`` lies wholly past a causal
    query block ``[q0, q0 + tq)`` and no key mask can leave a row without
    a live key (then the block adds exactly nothing)."""
    return causal and not masked and k0 > q0 + tq - 1


class _Spec:
    """The masking arguments of one attention call."""

    def __init__(self, causal: bool, window: int, key_mask: torch.Tensor | None,
                 query_mask: torch.Tensor | None) -> None:
        self.causal, self.window = causal, window
        self.key_mask, self.query_mask = key_mask, query_mask

    def live(self, q_pos: torch.Tensor, k_pos: torch.Tensor, k_lo: int, k_hi: int,
             key_mask: torch.Tensor | None, q_seg: torch.Tensor | None) -> Any:
        m_c = None if key_mask is None else key_mask[:, k_lo:k_hi]
        k_seg = m_c if q_seg is not None else None
        return _live(q_pos, k_pos, causal=self.causal, window=self.window, m_c=m_c,
                     q_seg=q_seg, k_seg=k_seg)


def chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int,
               kv_offset: int, causal: bool, kv_chunk: int,
               key_mask: torch.Tensor | None = None, query_mask: torch.Tensor | None = None,
               window: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``_chunk_scan``: the online softmax of q (B, Tq, H, D) over the
    key chunks of k/v (B, Tk, Hkv, D). Returns (acc, row_max, row_sum),
    acc un-normalized f32 (out = acc / row_sum), the others (B, Tq, H)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, tq, h, d = q.shape
    q_pos = q_offset + torch.arange(tq, device=q.device)
    acc = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, tq, h), NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, tq, h), dtype=torch.float32, device=q.device)
    spec = _Spec(causal, window, key_mask, query_mask)
    for lo in range(0, k.shape[1], kv_chunk):
        hi = min(lo + kv_chunk, k.shape[1])
        if _dead(q_offset, tq, kv_offset + lo, causal=causal, masked=key_mask is not None):
            continue
        s = _scores(q, k[:, lo:hi], scale)
        k_pos = kv_offset + torch.arange(lo, hi, device=q.device)
        live = spec.live(q_pos, k_pos, lo, hi, key_mask, query_mask)
        if live is not None:
            s = torch.where(live, s, NEG_INF)
        new_max = torch.maximum(row_max, s.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(s - new_max[..., None])
        acc = acc * correction[..., None] + _pv(p.to(v.dtype), v[:, lo:hi])
        row_sum = row_sum * correction + p.sum(dim=-1)
        row_max = new_max
    return acc, row_max, row_sum


def block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                delta: torch.Tensor, row_max: torch.Tensor, row_sum: torch.Tensor, *,
                q_offset: int, kv_offset: int, causal: bool, kv_chunk: int,
                key_mask: torch.Tensor | None = None, query_mask: torch.Tensor | None = None,
                window: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV (f32) of the queries q against the keys k/v, each block's
    probabilities recomputed from the rows' final max and sum:
    P = exp(s - max) / sum, dS = P (dO V^T - delta), delta = rowsum(dO O),
    zero at masked scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q_pos = q_offset + torch.arange(tq, device=q.device)
    dq = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    qf, do = q.float(), dout.float()
    spec = _Spec(causal, window, key_mask, query_mask)
    for lo in range(0, k.shape[1], kv_chunk):
        hi = min(lo + kv_chunk, k.shape[1])
        if _dead(q_offset, tq, kv_offset + lo, causal=causal, masked=key_mask is not None):
            continue
        kc, vc = k[:, lo:hi].float(), v[:, lo:hi].float()
        s = _scores(q, k[:, lo:hi], scale)
        k_pos = kv_offset + torch.arange(lo, hi, device=q.device)
        live = spec.live(q_pos, k_pos, lo, hi, key_mask, query_mask)
        if live is not None:
            s = torch.where(live, s, NEG_INF)
        p = torch.exp(s - row_max[..., None]) / row_sum[..., None]  # (B, Tq, H, Tk)
        tk = hi - lo
        pg = p.reshape(b, tq, hkv, g, tk)
        dog = do.reshape(b, tq, hkv, g, d)
        dv[:, lo:hi] += torch.einsum("bqkgs,bqkgd->bskd", pg, dog)
        dp = torch.einsum("bqkgd,bskd->bqkgs", dog, vc)
        ds = pg * (dp - delta.reshape(b, tq, hkv, g)[..., None])
        if live is not None:
            # A masked score takes no gradient (JAX's where); only a row
            # with no live key has nonzero probabilities there.
            ds = torch.where(live[:, :, :, None, :], ds, 0.0)
        dq += torch.einsum("bqkgs,bskd->bqkgd", ds, kc).reshape(b, tq, h, d) * scale
        dk[:, lo:hi] += torch.einsum("bqkgs,bqkgd->bskd", ds,
                                     qf.reshape(b, tq, hkv, g, d)) * scale
    return dq, dk, dv


def _chunks(tq: int, tk: int, q_chunk: int, kv_chunk: int) -> tuple[int, int]:
    q_chunk, kv_chunk = min(q_chunk, tq), min(kv_chunk, tk)
    if tq % q_chunk or tk % kv_chunk:
        # Ragged sizes: one chunk each (JAX's fallback).
        return tq, tk
    return q_chunk, kv_chunk


class _Blockwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, causal, q_chunk, kv_chunk, q_offset,
                kv_offset, window):
        out = torch.empty_like(q)
        b, tq, h, _ = q.shape
        row_max = q.new_empty((b, tq, h), dtype=torch.float32)
        row_sum = q.new_empty((b, tq, h), dtype=torch.float32)
        for lo in range(0, tq, q_chunk):
            hi = lo + q_chunk
            qm = None if query_mask is None else query_mask[:, lo:hi]
            acc, m, s = chunk_scan(q[:, lo:hi], k, v, q_offset=q_offset + lo,
                                   kv_offset=kv_offset, causal=causal, kv_chunk=kv_chunk,
                                   key_mask=key_mask, query_mask=qm, window=window)
            out[:, lo:hi] = (acc / s[..., None]).to(q.dtype)
            row_max[:, lo:hi], row_sum[:, lo:hi] = m, s
        ctx.save_for_backward(q, k, v, key_mask, query_mask, out, row_max, row_sum)
        ctx.args = (causal, q_chunk, kv_chunk, q_offset, kv_offset, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, query_mask, out, row_max, row_sum = ctx.saved_tensors
        causal, q_chunk, kv_chunk, q_offset, kv_offset, window = ctx.args
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for lo in range(0, q.shape[1], q_chunk):
            hi = lo + q_chunk
            qm = None if query_mask is None else query_mask[:, lo:hi]
            dq_c, dk_c, dv_c = block_grads(
                q[:, lo:hi], k, v, dout[:, lo:hi], delta[:, lo:hi], row_max[:, lo:hi],
                row_sum[:, lo:hi], q_offset=q_offset + lo, kv_offset=kv_offset,
                causal=causal, kv_chunk=kv_chunk, key_mask=key_mask, query_mask=qm,
                window=window)
            dq[:, lo:hi] = dq_c
            dk += dk_c
            dv += dv_c
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0, kv_offset: int = 0,
                        key_mask: torch.Tensor | None = None,
                        query_mask: torch.Tensor | None = None,
                        window: int = 0) -> torch.Tensor:
    """Exact attention over q (B, T, H, D) and narrow k/v (B, Tk, Hkv, D)
    with O(T * chunk) memory in the forward and the backward (the module
    docstring gives the masks and offsets). Raises as JAX's does for a
    negative window, a window without ``causal``, and a ``query_mask``
    without a ``key_mask``."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if query_mask is not None and key_mask is None:
        raise ValueError(
            "query_mask (segment semantics) requires key_mask — passing it "
            "alone would silently apply NO masking"
        )
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"n_heads ({q.shape[2]}) must be a multiple of kv heads ({k.shape[2]})")
    q_chunk, kv_chunk = _chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32)
    if query_mask is not None:
        query_mask = query_mask.to(torch.int32)
    return _Blockwise.apply(q, k, v, key_mask, query_mask, causal, q_chunk, kv_chunk,
                            int(q_offset), int(kv_offset), int(window))


__all__ = ["NEG_INF", "block_grads", "blockwise_attention", "chunk_scan"]
