"""Decoder-only GPT in PyTorch (port of ``llmtrain_tpu/models/gpt.py``).

Same architecture and rounding points as the flax module, so the same
weights (carried over by ``interop/flax_params.py``) give the same
logits: learned token + position embeddings, pre-norm blocks (LN → attn →
residual, LN → MLP(exact GELU) → residual), a final LN, and a tied or
untied bias-free lm-head. Compute runs in ``dtype`` over parameters kept
in their own dtype (cast at each use, as flax's ``dtype``/``param_dtype``
split does); LayerNorm statistics are f32 with flax's epsilon of 1e-6 and
its one-pass variance.

Attention (``attention``):

* ``flash`` — the hand-written CUDA kernel (ops/flash_attention.py) on
  the card, its plain version on the CPU. ``assume_packed`` drops the
  mask operand, as in JAX.
* ``dense`` — full-matrix attention with an f32 softmax
  (:func:`dense_attention`, the JAX ``dense_attention``).

Training mode: ``deterministic=False`` applies dropout where flax does
(embeddings, attention probabilities on the dense path, the attention
and MLP outputs), drawing from an explicit ``torch.Generator``;
``fused_norm`` runs ``ln_1`` and ``ln_2`` of every block through the
fused add+LayerNorm kernels (ops/fused_norm.py) with the same parameter
names as the unfused path, and is left out of the KV-cache decode path as
JAX clears it on decode clones.

The loss (``loss_impl``, resolved as in JAX by ops/fused_ce.py, with an
optional z-loss): ``dense`` computes the (B, T, V) logits and
``masked_ce_components`` (models/base.py); ``fused_ce`` (the hand-written
CUDA kernels of ops/fused_ce.py on the card) and ``chunked_ce`` (plain
torch, ops/chunked_ce.py) contract ``forward(..., return_hidden=True)``
against the (V, d) vocab matrix, so no (B, T, V) tensor is made.

Grouped-query attention (``n_kv_heads`` < ``n_heads``) uses ``q_proj`` +
``kv_proj`` in place of the fused ``qkv_proj``. Decoding, in plain torch
as JAX's decode paths are plain XLA, goes through :meth:`GPT.for_decoding`
(a per-layer KV cache written at a cursor, which ``generate()`` and
speculative decoding use) or :meth:`GPT.for_paged_decoding` (a pool of
fixed-size blocks shared by every sequence, addressed through per-row
block tables, with per-row positions: the continuous-batching engine's
cache). Both run :meth:`GPT.decode_forward`, whose row-wise ops
(LayerNorm, projections, lm-head) always take DECODE_ROWS rows and whose
attention takes each row's queries DECODE_ROWS at a time over a window of
fixed length, so a token's logits do not depend on the batch, the bucket,
the chunk or the call it was computed in.

The decode cache of :meth:`GPT.for_decoding` (JAX ``_decode_attention``):

* **linear** — ``cache_len`` slots, position p in slot p; the read is
  the whole cache, masked by col <= position;
* **rolling** (``sliding_window`` W shorter than ``block_size``) —
  ``min(W + ring_slack, cache_len)`` slots, position p in slot p % slots,
  the position each slot holds in ``pos1`` (position + 1, 0 = never
  written); a call writes only its last ``min(t, slots)`` tokens. Each
  query reads exactly the W positions ending at its own, in position
  order, gathered from the slots that still hold them (written, causal,
  inside the window: JAX's liveness). So its logits do not depend on the
  ring's size or slot order: speculative decoding, whose ring carries
  ``ring_slack`` extra slots, computes the bits ``generate()`` does;
* **int8** (``kv_cache_dtype: int8``, either layout) — codes plus one f32
  scale per (batch, slot, kv-head) from ops/quant.py's
  :func:`quantize_array` over the head dim, dequantized to the compute
  dtype before the products.

Rolling back the cursor (:meth:`KVCache.set_cursor`) is all speculative
decoding needs: slots past the cursor are masked until rewritten.

Weights quantized by ``ops/quant.quantize_model`` stay int8 on the model
and are dequantized at each use (:func:`_weight`), then cast to the
compute dtype as every weight is: once a call on the decode paths, not
once a block of rows (:func:`_dense_fn`).

Not yet ported, each raising at build time: ``matmul_precision`` other
than f32 and ring/ulysses attention (ROADMAP.md queue A: parallelism).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schemas import RunConfig
from ..ops import flash_attention as flash_ops
from ..ops import fused_norm as fused_norm_ops
from ..ops.chunked_ce import DEFAULT_CHUNK, chunked_ce_components
from ..ops.fused_ce import (
    DEFAULT_BLOCK_T,
    DEFAULT_BLOCK_V,
    LOSS_IMPLS,
    fused_ce_components,
    resolve_loss_impl,
)
from ..ops.quant import dequantized, quantize_array
from ..registry.models import register_model
from .base import Batch, ModelAdapter, lm_loss_components, validate_lm_batch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_INIT_STD = 0.02
# Rows per call of each row-wise op on the decode paths, and query rows per
# attention product. cuBLAS and PyTorch's reductions pick their algorithm
# (tile, split of the sum) by shape, so without a fixed row count a token's
# bits would depend on how many rows it shared a call with: a prompt
# padded to a bucket, a decode batch of 8, a prefill chunk, all against
# generate()'s exact lengths and batch of one.
DECODE_ROWS = 64


class _DeterministicEmbedding(torch.autograd.Function):
    """``F.embedding`` whose backward runs under torch's deterministic
    algorithms: aten's CUDA embedding backward otherwise accumulates the
    rows of repeated ids with atomics, so two runs of one step differ in
    the table's gradient (tools/grad_determinism.py), and a resumed run
    could not repeat the bits of an uninterrupted one. Only this op's
    backward runs in the mode; the rest of the step keeps torch's
    defaults."""

    @staticmethod
    def forward(ctx, ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_weights = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        enabled = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            grad_weight = torch.ops.aten.embedding_dense_backward(
                grad, ids, ctx.num_weights, -1, False)
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        return None, grad_weight


def embed(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``weight``: ``F.embedding``, with a backward that
    gives the same bits on every run on the card
    (:class:`_DeterministicEmbedding`); elsewhere aten's own."""
    if weight.is_cuda and weight.requires_grad and torch.is_grad_enabled():
        return _DeterministicEmbedding.apply(ids, weight)
    return F.embedding(ids, weight)


def apply_dropout(x: torch.Tensor, rate: float, deterministic: bool,
                  generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1/(1 - rate), drawing from ``generator``."""
    if rate == 0.0 or deterministic:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a torch.Generator")
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


def _weight(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype; a quantized one is dequantized to its
    original dtype first (JAX's ``QuantizedArray.__jax_array__``)."""
    return dequantized(w).to(dtype)


def _dense_fn(layer: nn.Linear, dtype: torch.dtype) -> Any:
    """flax ``Dense(dtype=...)`` as a function of its input: input, kernel
    and bias all cast to the compute dtype before the product. The kernel
    is cast (and dequantized) here, once, so that the decode paths' blocks
    of DECODE_ROWS rows share it."""
    w = _weight(layer.weight, dtype)
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return lambda x: F.linear(x.to(dtype), w, bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: epsilon 1e-6, f32 statistics with
    the one-pass variance E[x²]−E[x]² clipped at 0, output in ``dtype``."""

    def __init__(self, d: int, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=param_dtype))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


@dataclass
class LayerKVCache:
    """One layer's decode cache: (B, slots, Hkv, Dh) keys and values in the
    compute dtype (int8 codes with ``key_scale``/``value_scale``, (B,
    slots, Hkv, 1) f32), the absolute position of the next write, and for
    a rolling cache ``pos1`` (slots,): position + 1 held by each slot, 0
    for never written."""

    key: torch.Tensor
    value: torch.Tensor
    index: int = 0
    key_scale: torch.Tensor | None = None
    value_scale: torch.Tensor | None = None
    pos1: torch.Tensor | None = None

    def _store(self, at: Any, k: torch.Tensor, v: torch.Tensor) -> None:
        if self.key_scale is None:
            self.key[:, at] = k.to(self.key.dtype)
            self.value[:, at] = v.to(self.value.dtype)
            return
        for x, codes, scales in ((k, self.key, self.key_scale),
                                 (v, self.value, self.value_scale)):
            qa = quantize_array(x, reduce_axes=(x.ndim - 1,))
            codes[:, at] = qa.q
            scales[:, at] = qa.scale

    def write_read(self, k: torch.Tensor, v: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """Store this call's K/V (B, t, Hkv, Dh) at the cursor and return
        (keys, values, key positions): the whole cache in k's dtype, and
        the absolute position each slot holds (-1 for empty) for a rolling
        cache, None for a linear one (slot j holds position j)."""
        t, cap, idx = k.shape[1], self.key.shape[1], self.index
        if self.pos1 is None:
            if idx + t > cap:
                raise ValueError(f"decode cache overflow: {idx} + {t} > capacity {cap}")
            self._store(slice(idx, idx + t), k, v)
        else:
            # Only the last `cap` tokens of the call can survive the ring;
            # writing at most `cap` keeps the slots distinct.
            keep = min(t, cap)
            pos = torch.arange(idx + t - keep, idx + t, device=k.device)
            slots = pos % cap
            self._store(slots, k[:, t - keep:], v[:, t - keep:])
            self.pos1[slots] = pos + 1
        self.index = idx + t
        keys, values = self.key, self.value
        if self.key_scale is not None:
            keys = (keys.float() * self.key_scale).to(k.dtype)
            values = (values.float() * self.value_scale).to(v.dtype)
        return keys, values, None if self.pos1 is None else self.pos1 - 1


@dataclass
class KVCache:
    """The whole model's decode state: per-layer caches plus the position
    cursor that continues the learned positions across calls."""

    layers: list[LayerKVCache]
    position_index: int = 0

    def set_cursor(self, value: int) -> None:
        """Cursor-only rollback (JAX ``speculative._set_cursor``): the next
        call writes at absolute position ``value``. Slots past it keep
        stale K/V that no query reads: a linear cache masks positions past
        the query, a rolling one checks each slot's position."""
        self.position_index = value
        for layer in self.layers:
            layer.index = value


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: torch.Tensor | None,
    window: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Full-matrix causal attention (the JAX ``dense_attention``): scores
    in the compute dtype, softmax in f32, segment-id masking, dropout on
    the probabilities. q/k/v are (B, T, H, Dh) at full head width."""
    head_dim, seqlen = q.shape[-1], q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(head_dim))
    scores = scores.float()
    big_neg = torch.finfo(torch.float32).min
    pos = torch.arange(seqlen, device=q.device)
    live = pos[None, :] <= pos[:, None]
    if window:
        live = live & (pos[:, None] - pos[None, :] < window)
    scores = scores.masked_fill(~live[None, None], big_neg)
    if attention_mask is not None:
        seg = attention_mask
        seg_live = (seg != 0)[:, None, None, :] & (seg[:, None, :, None] == seg[:, None, None, :])
        scores = scores.masked_fill(~seg_live, big_neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = apply_dropout(probs, dropout_rate, deterministic, generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _row_blocks(fn: Any, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over consecutive blocks of DECODE_ROWS rows of ``x`` (N, ...),
    N a multiple of DECODE_ROWS."""
    if x.shape[0] == DECODE_ROWS:
        return fn(x)
    return torch.cat([fn(x[i : i + DECODE_ROWS]) for i in range(0, x.shape[0], DECODE_ROWS)])


def cached_attention(
    q: torch.Tensor,
    keys: torch.Tensor,
    values: torch.Tensor,
    positions: torch.Tensor,
    *,
    rows: int | None = None,
) -> torch.Tensor:
    """Causal attention of each row's queries over its own cached window
    (JAX ``_decode_attention``, linear cache, and ``_paged_decode_attention``).

    q (B, t, H, Dh); keys/values (B, S, Hkv, Dh), index j of row b holding
    position j; positions (B, t), the queries' absolute positions. Scores
    in the compute dtype with the grouped-query read, then f32, masked by
    col <= position with finfo(f32).min, softmaxed. Each row's queries go
    DECODE_ROWS at a time (the last block padded with fully masked rows)
    through one product per row and block, so every product has the same
    shape whatever the batch; the elementwise steps and the softmax, whose
    per-row arithmetic does not depend on the row count, run once over all
    rows. Only the first ``rows`` rows are computed (default all); the rest
    come back zero.
    """
    b, t, n_heads, head_dim = q.shape
    s, kv_width = keys.shape[1], keys.shape[2]
    g = n_heads // kv_width
    r = DECODE_ROWS
    tq = -(-t // r) * r
    nblk = tq // r
    if tq != t:
        q = F.pad(q, (0, 0, 0, 0, 0, tq - t))
        positions = F.pad(positions, (0, tq - t), value=-1)
    n = b if rows is None else rows
    # Each (row, block) as Hkv matrices of (G x r) queries, group-major;
    # each row's keys as (Hkv, Dh, S) and values as (Hkv, S, Dh).
    qm = (q[:n].reshape(n, nblk, r, kv_width, g, head_dim).permute(0, 1, 3, 4, 2, 5)
          .reshape(n * nblk, kv_width, g * r, head_dim).unbind(0))
    kts = keys[:n].permute(0, 2, 3, 1).unbind(0)
    vts = values[:n].permute(0, 2, 1, 3).unbind(0)
    scores = q.new_empty(n * nblk, kv_width, g * r, s)
    for ij, (qb, out_ij) in enumerate(zip(qm, scores.unbind(0))):
        torch.bmm(qb, kts[ij // nblk], out=out_ij)
    col = torch.arange(s, device=q.device)
    dead = col[None, None, :] > positions[:n, :, None]  # (n, tq, S)
    scores = (scores * (1.0 / math.sqrt(head_dim))).float()
    scores = scores.view(n, nblk, kv_width, g, r, s).masked_fill(
        dead.view(n, nblk, 1, 1, r, s), torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).view(n * nblk, kv_width, g * r, s)
    out = q.new_empty(n * nblk, kv_width, g * r, head_dim)
    for ij, (pb, out_ij) in enumerate(zip(probs.unbind(0), out.unbind(0))):
        torch.bmm(pb, vts[ij // nblk], out=out_ij)
    out = (out.view(n, nblk, kv_width, g, r, head_dim).permute(0, 1, 4, 2, 3, 5)
           .reshape(n, tq, n_heads, head_dim))
    if n != b:
        out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, b - n))
    return out[:, :t]


def window_attention(
    q: torch.Tensor,
    keys: torch.Tensor,
    values: torch.Tensor,
    key_pos: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    *,
    rows: int | None = None,
) -> torch.Tensor:
    """Sliding-window attention over a rolling cache (JAX
    ``_decode_attention``, rolling branch).

    q (B, t, H, Dh); keys/values (B, C, Hkv, Dh), the cache's slots;
    key_pos (C,), the absolute position each slot holds (-1 empty);
    positions (B, t), the queries' absolute positions. The query at p
    reads the ``window`` positions p - window + 1 .. p in that order, from
    slot position % C, each live iff the slot holds that position (JAX:
    written, causal and inside the window). Each row's queries go
    DECODE_ROWS at a time (the last block padded with dead queries)
    through one product per row and block, every query against its own
    keys, so neither the batch, nor the call, nor the ring's size moves a
    query's bits. Rows past ``rows`` come back zero.
    """
    b, t, n_heads, head_dim = q.shape
    cap, kv_width = keys.shape[1], keys.shape[2]
    g = n_heads // kv_width
    r = DECODE_ROWS
    tq = -(-t // r) * r
    nblk = tq // r
    if tq != t:
        q = F.pad(q, (0, 0, 0, 0, 0, tq - t))
        positions = F.pad(positions, (0, tq - t), value=-1)
    n = b if rows is None else rows
    wpos = positions[:n, :, None] + torch.arange(1 - window, 1, device=q.device)  # (n, tq, W)
    slots = wpos.remainder(cap)
    live = (wpos >= 0) & (key_pos[slots] == wpos)
    row = torch.arange(n, device=q.device)[:, None, None]
    # Each (row, block) as r x Hkv products of (G, Dh) queries against
    # their own (Dh, W) keys and (W, Dh) values.
    qm = q[:n].reshape(n * nblk, r * kv_width, g, head_dim).unbind(0)
    kts = keys[row, slots].reshape(n * nblk, r, window, kv_width, head_dim).permute(
        0, 1, 3, 4, 2).reshape(n * nblk, r * kv_width, head_dim, window).unbind(0)
    vts = values[row, slots].reshape(n * nblk, r, window, kv_width, head_dim).permute(
        0, 1, 3, 2, 4).reshape(n * nblk, r * kv_width, window, head_dim).unbind(0)
    scores = q.new_empty(n * nblk, r * kv_width, g, window)
    for qb, kb, out_ij in zip(qm, kts, scores.unbind(0)):
        torch.bmm(qb, kb, out=out_ij)
    scores = (scores * (1.0 / math.sqrt(head_dim))).float()
    scores = scores.view(n, tq, kv_width, g, window).masked_fill(
        ~live[:, :, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).view(n * nblk, r * kv_width, g, window)
    out = q.new_empty(n * nblk, r * kv_width, g, head_dim)
    for pb, vb, out_ij in zip(probs.unbind(0), vts, out.unbind(0)):
        torch.bmm(pb, vb, out=out_ij)
    out = out.view(n, tq, n_heads, head_dim)
    if n != b:
        out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, b - n))
    return out[:, :t]


def _attend(q: torch.Tensor, kv: tuple, positions: torch.Tensor, window: int,
            rows: int | None) -> torch.Tensor:
    """Attention over what a cache's ``write_read`` returned: (keys,
    values, key positions), the positions None for a linear layout."""
    keys, values, key_pos = kv
    if key_pos is None:
        return cached_attention(q, keys, values, positions, rows=rows)
    return window_attention(q, keys, values, key_pos, positions, window, rows=rows)


class CausalSelfAttention(nn.Module):
    def __init__(
        self,
        d_model: int,
        n_heads: int,
        *,
        dtype: torch.dtype,
        param_dtype: torch.dtype,
        attention: str = "dense",
        n_kv_heads: int = 0,
        assume_packed: bool = False,
        use_bias: bool = True,
        rope: bool = False,
        rope_theta: float = 10000.0,
        sliding_window: int = 0,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.dropout = dropout
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.kv_heads = n_kv_heads or n_heads
        if n_heads % self.kv_heads != 0:
            raise ValueError(
                f"n_heads ({n_heads}) must be divisible by n_kv_heads ({self.kv_heads})"
            )
        self.dtype = dtype
        self.attention = attention
        self.assume_packed = assume_packed
        self.rope = rope
        self.rope_theta = rope_theta
        self.sliding_window = sliding_window
        width = n_heads * self.head_dim
        kw = dict(dtype=param_dtype)
        if self.kv_heads == n_heads:
            # Output features ordered (3, H, Dh): the flax (D, 3, H, Dh)
            # kernel flattened in C order.
            self.qkv_proj = nn.Linear(d_model, 3 * width, bias=use_bias, **kw)
        else:
            self.q_proj = nn.Linear(d_model, width, bias=use_bias, **kw)
            self.kv_proj = nn.Linear(d_model, 2 * self.kv_heads * self.head_dim,
                                     bias=use_bias, **kw)
        self.out_proj = nn.Linear(width, d_model, bias=use_bias, **kw)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        cache: LayerKVCache | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        b, t, _ = x.shape
        h, hd, hkv = self.n_heads, self.head_dim, self.kv_heads
        q, k, v = self._split_qkv(*self._project(x, lambda f: f(x)), b, t)
        if self.rope and cache is None:
            from ..ops.rope import apply_rope

            q, k = apply_rope(q, k, torch.arange(t, device=x.device), theta=self.rope_theta)

        if cache is not None:
            out = self._decode_attention(q, k, v, cache)
        elif self.attention == "flash":
            out = flash_ops.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                attention_mask=None if self.assume_packed else attention_mask,
                causal=True,
                window=self.sliding_window,
            )
        elif self.attention == "dense":
            if hkv != h:
                k = k.repeat_interleave(h // hkv, dim=2)
                v = v.repeat_interleave(h // hkv, dim=2)
            out = dense_attention(q, k, v, attention_mask=attention_mask,
                                  window=self.sliding_window, dropout_rate=self.dropout,
                                  deterministic=deterministic, generator=generator)
        else:
            raise NotImplementedError(
                f"attention={self.attention!r} is not yet ported to llmtrain_tpu_torch "
                "(ROADMAP.md queue A: parallelism); use 'flash' or 'dense'"
            )

        out = _dense_fn(self.out_proj, self.dtype)(out.reshape(b, t, h * hd))
        out = apply_dropout(out, self.dropout, deterministic, generator)
        if attention_mask is not None:
            # Zero padded rows (the mask may carry segment ids > 1).
            out = out * (attention_mask != 0)[:, :, None].to(out.dtype)
        return out

    def _project(self, x: torch.Tensor, apply: Any) -> tuple[torch.Tensor, ...]:
        """The input projections, each through ``apply`` (called with the
        function of one block of rows): (qkv,) fused or (q, kv) under GQA."""
        if self.kv_heads == self.n_heads:
            return (apply(_dense_fn(self.qkv_proj, self.dtype)),)
        return (apply(_dense_fn(self.q_proj, self.dtype)),
                apply(_dense_fn(self.kv_proj, self.dtype)))

    def _split_qkv(self, *parts: Any) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q (B, T, H, Dh), k and v (B, T, Hkv, Dh) from the projections of
        B x T rows."""
        *proj, b, t = parts
        h, hd, hkv = self.n_heads, self.head_dim, self.kv_heads
        if hkv == h:
            return proj[0].reshape(b, t, 3, h, hd).unbind(dim=2)
        k, v = proj[1].reshape(b, t, 2, hkv, hd).unbind(dim=2)
        return proj[0].reshape(b, t, h, hd), k, v

    def _decode_attention(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: LayerKVCache
    ) -> torch.Tensor:
        """Write this call's K/V at the cursor, attend over the cache (JAX
        ``_decode_attention``). The cache stays at n_kv_heads; queries are
        grouped against it at read."""
        batch, t = q.shape[:2]
        positions = (cache.index + torch.arange(t, device=q.device)).expand(batch, t)
        if self.rope:
            from ..ops.rope import apply_rope

            q, k = apply_rope(q, k, positions, theta=self.rope_theta)
        return _attend(q, cache.write_read(k, v), positions, self.sliding_window, None)

    def decode_rows(
        self,
        h: torch.Tensor,
        shape: tuple[int, int],
        positions: torch.Tensor,
        write_read: Any,
        rows: int | None,
    ) -> torch.Tensor:
        """The attention sublayer on the decode paths: ``h`` holds the
        B x T tokens' normed rows, padded to a multiple of DECODE_ROWS;
        ``write_read(k, v)`` stores this call's K/V and returns every row's
        window (with the slots' positions, or None for a linear layout).
        Returns the output projection, padded alike."""
        b, t = shape
        n = b * t
        q, k, v = self._split_qkv(
            *(p[:n] for p in self._project(h, lambda f: _row_blocks(f, h))), b, t
        )
        if self.rope:
            from ..ops.rope import apply_rope

            q, k = apply_rope(q, k, positions, theta=self.rope_theta)
        out = _attend(q, write_read(k, v), positions, self.sliding_window, rows)
        out = F.pad(out.reshape(n, -1), (0, 0, 0, h.shape[0] - n))
        return _row_blocks(_dense_fn(self.out_proj, self.dtype), out)


class TransformerBlock(nn.Module):
    """Pre-norm block. With ``fused_norm``, ``ln_1`` is
    :func:`fused_layer_norm` of the block input and ``ln_2`` is
    :func:`fused_add_layer_norm`, which also returns the residual sum
    (JAX ``FusedLayerNorm``); the parameters are the same ``ln_*``
    weight/bias either way. The decode paths (:meth:`decode_rows`) always
    run the unfused LayerNorm, as JAX clears ``fused_norm`` on decode
    clones."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, dropout: float = 0.0, fused_norm: bool = False,
                 **attn_kw: Any) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.fused_norm = fused_norm
        self.ln_1 = LayerNorm(d_model, dtype=dtype, param_dtype=param_dtype)
        self.attn = CausalSelfAttention(d_model, n_heads, dtype=dtype,
                                        param_dtype=param_dtype, dropout=dropout, **attn_kw)
        self.ln_2 = LayerNorm(d_model, dtype=dtype, param_dtype=param_dtype)
        self.mlp_fc = nn.Linear(d_model, d_ff, dtype=param_dtype)
        self.mlp_proj = nn.Linear(d_ff, d_model, dtype=param_dtype)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        attn_kw = dict(deterministic=deterministic, generator=generator)
        if self.fused_norm:
            x = x.to(self.dtype)
            h = fused_norm_ops.fused_layer_norm(x, self.ln_1.weight, self.ln_1.bias,
                                                self.ln_1.eps)
            attn_out = self.attn(h, attention_mask, **attn_kw)
            h, x = fused_norm_ops.fused_add_layer_norm(attn_out, x, self.ln_2.weight,
                                                       self.ln_2.bias, self.ln_2.eps)
        else:
            x = x + self.attn(self.ln_1(x), attention_mask, **attn_kw)
            h = self.ln_2(x)
        return x + apply_dropout(self._mlp()(h), self.dropout, deterministic, generator)

    def _mlp(self) -> Any:
        """The MLP as a function of its input, its kernels cast once."""
        fc, proj = _dense_fn(self.mlp_fc, self.dtype), _dense_fn(self.mlp_proj, self.dtype)
        return lambda h: proj(F.gelu(fc(h), approximate="none"))

    def decode_rows(self, x: torch.Tensor, shape: tuple[int, int], positions: torch.Tensor,
                    write_read: Any, rows: int | None) -> torch.Tensor:
        """The block on the decode paths, over rows padded to a multiple of
        DECODE_ROWS (see :meth:`CausalSelfAttention.decode_rows`)."""
        h = _row_blocks(self.ln_1, x)
        x = x + self.attn.decode_rows(h, shape, positions, write_read, rows)
        return x + _row_blocks(self._mlp(), _row_blocks(self.ln_2, x))


class GPT(nn.Module):
    """Decoder-only GPT language model."""

    def __init__(
        self,
        *,
        vocab_size: int,
        block_size: int,
        d_model: int,
        n_layers: int,
        n_heads: int,
        d_ff: int,
        tie_embeddings: bool = True,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        attention: str = "dense",
        n_kv_heads: int = 0,
        assume_packed: bool = False,
        sliding_window: int = 0,
        kv_cache_dtype: str = "model",
        rope: bool = False,
        rope_theta: float = 10000.0,
        dropout: float = 0.0,
        fused_norm: bool = False,
        loss_impl: str = "dense",
        z_loss: float = 0.0,
        ce_chunk: int = DEFAULT_CHUNK,
        fused_ce_block_t: int = DEFAULT_BLOCK_T,
        fused_ce_block_v: int = DEFAULT_BLOCK_V,
    ) -> None:
        super().__init__()
        self.dropout = dropout
        self.fused_norm = fused_norm
        self.loss_impl = loss_impl
        self.z_loss = z_loss
        self.ce_chunk = ce_chunk
        self.fused_ce_block_t = fused_ce_block_t
        self.fused_ce_block_v = fused_ce_block_v
        self.vocab_size = vocab_size
        self.block_size = block_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.attention = attention
        self.sliding_window = sliding_window
        self.kv_cache_dtype = kv_cache_dtype
        self.token_embedding = nn.Embedding(vocab_size, d_model, dtype=param_dtype)
        self.position_embedding = nn.Embedding(block_size, d_model, dtype=param_dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                d_model, n_heads, d_ff, dtype=dtype, param_dtype=param_dtype,
                attention=attention, n_kv_heads=n_kv_heads, assume_packed=assume_packed,
                sliding_window=sliding_window, rope=rope, rope_theta=rope_theta,
                dropout=dropout, fused_norm=fused_norm,
            )
            for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, dtype=dtype, param_dtype=param_dtype)
        self.lm_head = (
            None if tie_embeddings
            else nn.Linear(d_model, vocab_size, bias=False, dtype=param_dtype)
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initialization: N(0, 0.02) embeddings and projections,
        N(0, 0.02/sqrt(2·n_layers)) residual projections (out_proj,
        mlp_proj), zero biases, unit LayerNorm scales. Random numbers come
        from ``generator`` (on the parameters' device)."""
        residual_std = _INIT_STD / math.sqrt(2 * self.n_layers)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_f"):
                p.fill_(1.0)
            else:
                std = residual_std if ("out_proj" in name or "mlp_proj" in name) else _INIT_STD
                nn.init.normal_(p, 0.0, std, generator=generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        cache: KVCache | None = None,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        """Logits (B, T, V) in the compute dtype. ``deterministic=False``
        applies dropout from ``generator``. ``return_hidden`` returns
        ``ln_f``'s output (B, T, d) without the lm-head, for the streamed
        losses that contract it against :meth:`vocab_matrix` themselves."""
        batch, seqlen = input_ids.shape
        if seqlen > self.block_size:
            raise ValueError(
                f"Input sequence length {seqlen} exceeds block size {self.block_size}."
            )
        if cache is not None:
            # Positions continue from the cache cursor across calls.
            start = cache.position_index
            cache.position_index += seqlen
            positions = torch.arange(start, start + seqlen, device=input_ids.device)
            return self.decode_forward(input_ids, positions.expand(batch, seqlen),
                                       lambda layer: cache.layers[layer].write_read)
        pos = torch.arange(seqlen, device=input_ids.device)
        x = (embed(input_ids, dequantized(self.token_embedding.weight)).to(self.dtype)
             + embed(pos, dequantized(self.position_embedding.weight)).to(self.dtype)[None])
        x = apply_dropout(x, self.dropout, deterministic, generator)
        for block in self.blocks:
            x = block(x, attention_mask, deterministic=deterministic, generator=generator)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return F.linear(x, _weight(self.vocab_matrix(), self.dtype))

    def decode_forward(
        self,
        input_ids: torch.Tensor,
        positions: torch.Tensor,
        write_read: Any,
        *,
        rows: int | None = None,
    ) -> torch.Tensor:
        """Logits (B, T, V) of the decode paths. ``positions`` (B, T) are
        the tokens' absolute positions (a position past the model's last,
        which only a padded token has, reads the last position embedding);
        ``write_read(layer)`` gives the layer's ``(k, v) -> (keys, values,
        key positions)`` that stores this call's K/V and returns every row's
        window (key positions None for a linear layout, where index j holds
        position j). The
        B x T token rows are padded to a multiple of DECODE_ROWS and every
        row-wise op runs DECODE_ROWS rows at a time; attention is computed
        for the first ``rows`` rows only (default all)."""
        b, t = input_ids.shape
        n = b * t
        pos = positions.clamp(max=self.block_size - 1)
        x = (F.embedding(input_ids, dequantized(self.token_embedding.weight)).to(self.dtype)
             + F.embedding(pos, dequantized(self.position_embedding.weight)).to(self.dtype))
        x = F.pad(x.reshape(n, -1), (0, 0, 0, -(-n // DECODE_ROWS) * DECODE_ROWS - n))
        for i, block in enumerate(self.blocks):
            x = block.decode_rows(x, (b, t), positions, write_read(i), rows)
        x = _row_blocks(self.ln_f, x)
        w = _weight(self.vocab_matrix(), self.dtype)
        return _row_blocks(lambda r: F.linear(r, w), x)[:n].view(b, t, -1)

    def vocab_matrix(self) -> torch.Tensor:
        """The (V, d) output-projection parameter: the tied
        ``token_embedding.weight`` or the untied ``lm_head.weight`` (torch
        keeps both as (V, d); JAX transposes its untied kernel)."""
        if self.tie_embeddings:
            return self.token_embedding.weight
        return self.lm_head.weight

    def for_decoding(self, cache_len: int | None = None, *, ring_slack: int = 0) -> GPTDecoder:
        """KV-cache decoding view of this model (JAX ``for_decoding``):
        same parameters, a cache of ``min(cache_len, block_size)``
        positions. ``ring_slack`` widens a windowed model's rolling cache
        by that many slots, so that writes a speculative round rolls back
        cannot evict a position a later query's window holds
        (speculative.py passes gamma + 1)."""
        if cache_len is None:
            cache_len = self.block_size
        return GPTDecoder(self, min(cache_len, self.block_size), ring_slack)

    def for_paged_decoding(self, *, num_blocks: int, block_tokens: int) -> GPTPagedDecoder:
        """Paged-KV decoding view of this model (JAX ``for_paged_decoding``):
        same parameters, a pool of ``num_blocks`` blocks of ``block_tokens``
        positions shared by every in-flight sequence; block 0 is the null
        block padded table entries point at, so the pool holds at least 2.
        The sliding-window and int8 caches are refused, as in JAX."""
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (got {num_blocks})")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1 (got {block_tokens})")
        if self.sliding_window:
            raise ValueError(
                "paged decode does not support sliding_window models yet; "
                "use for_decoding() (rolling-ring cache)"
            )
        if self.kv_cache_dtype != "model":
            raise ValueError(
                "paged decode does not support kv_cache_dtype="
                f"{self.kv_cache_dtype!r} yet; use for_decoding()"
            )
        return GPTPagedDecoder(self, num_blocks, block_tokens)


@dataclass
class GPTDecoder:
    """Cached autoregressive decoding over a :class:`GPT`: prefill with
    the prompt, then one token per call, each call appending to the
    cache from :meth:`init_cache`. A model whose ``sliding_window`` is
    shorter than its ``block_size`` decodes through a rolling cache of
    ``min(sliding_window + ring_slack, cache_len)`` slots (a longer
    window never binds); ``kv_cache_dtype: int8`` stores int8 codes and
    scales."""

    model: GPT
    cache_len: int
    ring_slack: int = 0

    def __post_init__(self) -> None:
        if self.cache_len <= 0:
            raise ValueError("decoding requires cache_len > 0")
        if self.ring_slack < 0:
            raise ValueError(f"ring_slack must be >= 0, got {self.ring_slack}")
        if self.model.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"kv_cache_dtype {self.model.kv_cache_dtype!r} unknown; expected "
                "'model' or 'int8'"
            )

    @property
    def slots(self) -> int:
        """Cache positions per layer: the ring under a sliding window."""
        window = self.model.sliding_window
        if 0 < window < self.model.block_size:
            return min(window + self.ring_slack, self.cache_len)
        return self.cache_len

    def init_cache(self, batch: int) -> KVCache:
        m = self.model
        dev = m.token_embedding.weight.device
        slots = self.slots
        shape = (batch, slots, m.n_kv_heads, m.d_model // m.n_heads)
        quant = m.kv_cache_dtype == "int8"
        rolling = 0 < m.sliding_window < m.block_size

        def zeros(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=dev)

        def layer() -> LayerKVCache:
            store = torch.int8 if quant else m.dtype
            scale = shape[:3] + (1,)
            return LayerKVCache(
                zeros(shape, store), zeros(shape, store),
                key_scale=zeros(scale, torch.float32) if quant else None,
                value_scale=zeros(scale, torch.float32) if quant else None,
                pos1=zeros((slots,), torch.long) if rolling else None,
            )

        return KVCache(layers=[layer() for _ in range(m.n_layers)])

    def __call__(self, input_ids: torch.Tensor, cache: KVCache) -> torch.Tensor:
        return self.model(input_ids, cache=cache)


@dataclass
class PagedKVCache:
    """The paged decode cache: per layer, key and value pools of shape
    (num_blocks, block_tokens, Hkv, Dh) in the compute dtype. Shared by
    every sequence and every batch size; block 0 is the null block."""

    key: list[torch.Tensor]
    value: list[torch.Tensor]

    def zero_(self) -> None:
        for t in (*self.key, *self.value):
            t.zero_()


@dataclass
class GPTPagedDecoder:
    """Paged-KV decoding over a :class:`GPT` (JAX's paged decode clone):
    rows at different depths in one call, each with its own positions and
    block table (serving/engine.py drives it)."""

    model: GPT
    num_blocks: int
    block_tokens: int

    def init_pool(self) -> PagedKVCache:
        m = self.model
        shape = (self.num_blocks, self.block_tokens, m.n_kv_heads, m.d_model // m.n_heads)
        dev = m.token_embedding.weight.device

        def zeros() -> list[torch.Tensor]:
            return [torch.zeros(shape, dtype=m.dtype, device=dev) for _ in range(m.n_layers)]

        return PagedKVCache(zeros(), zeros())

    def __call__(
        self,
        input_ids: torch.Tensor,  # (B, T)
        positions: torch.Tensor,  # (B,) absolute position of input_ids[:, 0]
        block_tables: torch.Tensor,  # (B, ceil(block_size / block_tokens)) block ids
        pool: PagedKVCache,
        *,
        true_len: torch.Tensor | None = None,  # (B,) real tokens per row
        rows: int | None = None,
    ) -> torch.Tensor:
        """Logits (B, T, V). Token t of row b writes its K/V at
        ``pool[table[b, p // bt], p % bt]`` with p = positions[b] + t, then
        every row attends its window gathered through its table (the
        first ``block_size`` positions) masked by col <= p. Tokens past
        ``true_len`` (padding) write into the null block; the attention of
        rows past ``rows`` (padded rows) is not computed."""
        b, t = input_ids.shape
        bt = self.block_tokens
        dev = input_ids.device
        pos = positions[:, None] + torch.arange(t, device=dev)[None, :]
        blocks = block_tables.gather(1, (pos // bt).clamp(max=block_tables.shape[1] - 1))
        if true_len is not None:
            real = torch.arange(t, device=dev)[None, :] < true_len[:, None]
            blocks = torch.where(real, blocks, torch.zeros_like(blocks))
        # Pool rows (block * bt + slot) written by this call, and those of
        # each row's window, in order.
        written = (blocks * bt + pos % bt).reshape(-1)
        window = self.model.block_size
        read = (block_tables[:, :, None] * bt + torch.arange(bt, device=dev)).reshape(b, -1)
        read = read[:, :window].reshape(-1)

        def write_read(layer: int) -> Any:
            pk, pv = (p.view(-1, *p.shape[2:]) for p in (pool.key[layer], pool.value[layer]))

            def wr(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, None]:
                pk.index_copy_(0, written, k.reshape(-1, *pk.shape[1:]).to(pk.dtype))
                pv.index_copy_(0, written, v.reshape(-1, *pv.shape[1:]).to(pv.dtype))
                return (pk.index_select(0, read).view(b, window, *pk.shape[1:]),
                        pv.index_select(0, read).view(b, window, *pv.shape[1:]), None)

            return wr

        return self.model.decode_forward(input_ids, pos, write_read, rows=rows)


@register_model("gpt")
class GPTAdapter(ModelAdapter):
    """Model adapter for the decoder-only GPT."""

    known_extra_keys = frozenset(
        {"tokenizer", "loss_impl", "ce_chunk", "z_loss", "n_kv_heads",
         "assume_packed", "remat_policy", "sliding_window",
         "kv_cache_dtype", "matmul_precision", "ce_auto_vocab",
         "activation_tiers", "fused_ce_block_t", "fused_ce_block_v",
         "fused_norm", "pallas_interpret"}
    )

    def build_model(self, cfg: RunConfig, device: torch.device | None = None) -> GPT:
        m = cfg.model
        vocab_size = m.vocab_size
        if vocab_size is None:
            tokenizer = self.build_tokenizer(cfg)
            tokenizer_vocab_size = getattr(tokenizer, "n_vocab", None)
            if not isinstance(tokenizer_vocab_size, int) or tokenizer_vocab_size <= 0:
                raise ValueError("GPT tokenizer must expose a positive integer n_vocab.")
            vocab_size = tokenizer_vocab_size
        loss_impl = resolve_loss_impl(
            m.extra.get("loss_impl"),
            vocab_size=vocab_size,
            ce_auto_vocab=self._positive_extra(cfg, "ce_auto_vocab", 32768),
        )
        ce_chunk = self._positive_extra(cfg, "ce_chunk", DEFAULT_CHUNK)
        block_t = self._positive_extra(cfg, "fused_ce_block_t", DEFAULT_BLOCK_T)
        block_v = self._positive_extra(cfg, "fused_ce_block_v", DEFAULT_BLOCK_V)
        z_loss = float(m.extra.get("z_loss", 0.0))
        if z_loss < 0.0:
            raise ValueError(f"model.extra.z_loss must be >= 0, got {z_loss}")
        precision = str(m.extra.get("matmul_precision", "f32"))
        if precision != "f32":
            raise NotImplementedError(
                f"model.extra.matmul_precision={precision!r} is not yet ported to "
                "llmtrain_tpu_torch (ROADMAP.md queue A: parallelism); use 'f32'"
            )
        n_kv_heads = int(m.extra.get("n_kv_heads", 0))
        if n_kv_heads < 0:
            raise ValueError(f"model.extra.n_kv_heads must be >= 0, got {n_kv_heads}")
        if n_kv_heads and m.n_heads % n_kv_heads != 0:
            raise ValueError(
                f"model.n_heads ({m.n_heads}) must be divisible by "
                f"model.extra.n_kv_heads ({n_kv_heads})"
            )
        if m.attention in ("flash", "ring", "ulysses") and m.dropout > 0.0:
            raise ValueError(
                f"attention={m.attention!r} does not support "
                "attention-probability dropout; set model.dropout to 0.0 or "
                "use attention='dense'"
            )
        if m.attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={m.attention!r} is not yet ported to llmtrain_tpu_torch "
                "(ROADMAP.md queue A: parallelism); use 'flash' or 'dense'"
            )
        kv_cache_dtype = str(m.extra.get("kv_cache_dtype", "model"))
        if kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"model.extra.kv_cache_dtype {kv_cache_dtype!r} unknown; "
                "expected 'model' or 'int8'"
            )
        sliding_window = int(m.extra.get("sliding_window", 0))
        if sliding_window < 0:
            raise ValueError(f"model.extra.sliding_window must be >= 0, got {sliding_window}")
        model = GPT(
            vocab_size=vocab_size,
            block_size=m.block_size,
            d_model=m.d_model,
            n_layers=m.n_layers,
            n_heads=m.n_heads,
            d_ff=m.d_ff,
            tie_embeddings=m.tie_embeddings,
            dtype=DTYPES[m.dtype],
            param_dtype=DTYPES[m.param_dtype],
            attention=m.attention,
            n_kv_heads=n_kv_heads,
            assume_packed=bool(m.extra.get("assume_packed", False)),
            sliding_window=sliding_window,
            kv_cache_dtype=kv_cache_dtype,
            dropout=m.dropout,
            fused_norm=bool(m.extra.get("fused_norm", False)),
            loss_impl=loss_impl,
            z_loss=z_loss,
            ce_chunk=ce_chunk,
            fused_ce_block_t=block_t,
            fused_ce_block_v=block_v,
        )
        if device is not None:
            model = model.to(device)
        generator = torch.Generator(device=model.token_embedding.weight.device)
        generator.manual_seed(cfg.run.seed)
        model.init_weights(generator)
        return model.eval()

    def build_tokenizer(self, cfg: RunConfig) -> Any | None:
        """``model.extra.tokenizer`` (default ``gpt2``, as in JAX)."""
        from ..data.tokenizers import build_tokenizer

        return build_tokenizer(cfg.model.extra.get("tokenizer", "gpt2"))

    def compute_loss_components(
        self,
        model: GPT,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-example ``(loss_sum, token_count)``, dispatched on the
        model's ``loss_impl`` as JAX's adapter does: the streamed losses
        through :meth:`_chunked_loss_components`, ``dense`` through the
        full logits."""
        if model.loss_impl in ("chunked_ce", "fused_ce"):
            return self._chunked_loss_components(model, batch, generator=generator,
                                                 deterministic=deterministic)
        if model.loss_impl != "dense":
            raise ValueError(
                f"loss_impl {model.loss_impl!r} unknown; expected one of {', '.join(LOSS_IMPLS)}"
            )
        return lm_loss_components(model, batch, generator=generator,
                                  deterministic=deterministic)

    # The (V, d) output-projection matrix of a model (JAX ``vocab_matrix``).
    vocab_matrix = staticmethod(GPT.vocab_matrix)

    @classmethod
    def chunked_components_from_hidden(
        cls,
        model: GPT,
        hidden: torch.Tensor,
        labels: torch.Tensor,
        attention_mask: torch.Tensor | None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Streamed or fused CE components from ``ln_f``'s output:
        ``fused_ce`` runs the fused kernels (ops/fused_ce.py), anything
        else the chunked stream (ops/chunked_ce.py)."""
        if model.loss_impl == "fused_ce":
            return fused_ce_components(
                hidden, cls.vocab_matrix(model), labels, attention_mask,
                block_t=model.fused_ce_block_t, block_v=model.fused_ce_block_v,
                z_loss=model.z_loss,
            )
        return chunked_ce_components(hidden, cls.vocab_matrix(model), labels, attention_mask,
                                     chunk=model.ce_chunk, z_loss=model.z_loss)

    @classmethod
    def _chunked_loss_components(
        cls,
        model: GPT,
        batch: Batch,
        *,
        generator: torch.Generator | None,
        deterministic: bool,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The dense path's loss, without the (B, T, V) logits."""
        input_ids, labels, attention_mask = validate_lm_batch(batch)
        hidden = model(input_ids.long(), attention_mask, deterministic=deterministic,
                       generator=generator, return_hidden=True)
        return cls.chunked_components_from_hidden(model, hidden, labels, attention_mask)


__all__ = [
    "GPT",
    "GPTAdapter",
    "GPTDecoder",
    "GPTPagedDecoder",
    "CausalSelfAttention",
    "DECODE_ROWS",
    "KVCache",
    "LayerKVCache",
    "LOSS_IMPLS",
    "LayerNorm",
    "PagedKVCache",
    "TransformerBlock",
    "apply_dropout",
    "cached_attention",
    "dense_attention",
    "window_attention",
    "resolve_loss_impl",
]
