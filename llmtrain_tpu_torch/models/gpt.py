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
``kv_proj`` in place of the fused ``qkv_proj``. Decoding goes through
:meth:`GPT.for_decoding`: a per-layer KV cache written at a cursor and
read with the GQA broadcast, in plain torch (the JAX decode path is plain
XLA, no Pallas kernel).

Not yet ported, each raising: ``matmul_precision`` other than f32 and
ring/ulysses attention (at build time), the rolling sliding-window decode
cache and the int8 KV cache (at decode) (ROADMAP.md queue A: parallelism for
the first two, continuous serving for the caches).
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
from ..registry.models import register_model
from .base import Batch, ModelAdapter, lm_loss_components, validate_lm_batch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_INIT_STD = 0.02


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


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias all cast to the
    compute dtype before the product."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
    """One layer's decode cache: (B, capacity, Hkv, Dh) keys and values
    in the compute dtype, and the cursor of the next write."""

    key: torch.Tensor
    value: torch.Tensor
    index: int = 0


@dataclass
class KVCache:
    """The whole model's decode state: per-layer caches plus the position
    cursor that continues the learned positions across calls."""

    layers: list[LayerKVCache]
    position_index: int = 0


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
        if hkv == h:
            qkv = _dense(x, self.qkv_proj, self.dtype).view(b, t, 3, h, hd)
            q, k, v = qkv.unbind(dim=2)
        else:
            q = _dense(x, self.q_proj, self.dtype).view(b, t, h, hd)
            kv = _dense(x, self.kv_proj, self.dtype).view(b, t, 2, hkv, hd)
            k, v = kv.unbind(dim=2)
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

        out = _dense(out.reshape(b, t, h * hd), self.out_proj, self.dtype)
        out = apply_dropout(out, self.dropout, deterministic, generator)
        if attention_mask is not None:
            # Zero padded rows (the mask may carry segment ids > 1).
            out = out * (attention_mask != 0)[:, :, None].to(out.dtype)
        return out

    def _decode_attention(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: LayerKVCache
    ) -> torch.Tensor:
        """Write this call's K/V at the cursor, attend over the filled
        prefix (JAX ``_decode_attention``, linear cache). The cache stays
        at n_kv_heads; queries are grouped against it at read."""
        batch, t, n_heads, head_dim = q.shape
        cap = cache.key.shape[1]
        idx = cache.index
        if idx + t > cap:
            raise ValueError(f"decode cache overflow: {idx} + {t} > capacity {cap}")
        if self.rope:
            from ..ops.rope import apply_rope

            q, k = apply_rope(
                q, k, idx + torch.arange(t, device=q.device), theta=self.rope_theta
            )
        cache.key[:, idx : idx + t] = k.to(cache.key.dtype)
        cache.value[:, idx : idx + t] = v.to(cache.value.dtype)
        cache.index = idx + t

        kv_width = cache.key.shape[2]
        g = n_heads // kv_width
        qg = q.reshape(batch, t, kv_width, g, head_dim)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache.key) * (1.0 / math.sqrt(head_dim))
        scores = scores.float()
        row = (idx + torch.arange(t, device=q.device))[:, None]
        col = torch.arange(cap, device=q.device)[None, :]
        live = col <= row
        if self.sliding_window:
            live = live & (row - col < self.sliding_window)
        scores = scores.masked_fill(~live, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache.value)
        return out.reshape(batch, t, n_heads, head_dim)


class TransformerBlock(nn.Module):
    """Pre-norm block. With ``fused_norm`` (and no decode cache), ``ln_1``
    is :func:`fused_layer_norm` of the block input and ``ln_2`` is
    :func:`fused_add_layer_norm`, which also returns the residual sum
    (JAX ``FusedLayerNorm``); the parameters are the same ``ln_*``
    weight/bias either way."""

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
        cache: LayerKVCache | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        attn_kw = dict(deterministic=deterministic, generator=generator)
        if self.fused_norm and cache is None:
            x = x.to(self.dtype)
            h = fused_norm_ops.fused_layer_norm(x, self.ln_1.weight, self.ln_1.bias,
                                                self.ln_1.eps)
            attn_out = self.attn(h, attention_mask, cache, **attn_kw)
            h, x = fused_norm_ops.fused_add_layer_norm(attn_out, x, self.ln_2.weight,
                                                       self.ln_2.bias, self.ln_2.eps)
        else:
            x = x + self.attn(self.ln_1(x), attention_mask, cache, **attn_kw)
            h = self.ln_2(x)
        h = F.gelu(_dense(h, self.mlp_fc, self.dtype), approximate="none")
        h = _dense(h, self.mlp_proj, self.dtype)
        return x + apply_dropout(h, self.dropout, deterministic, generator)


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
        _, seqlen = input_ids.shape
        if seqlen > self.block_size:
            raise ValueError(
                f"Input sequence length {seqlen} exceeds block size {self.block_size}."
            )
        start = 0
        if cache is not None:
            # Positions continue from the cache cursor across calls.
            start = cache.position_index
            cache.position_index += seqlen
        pos = torch.arange(start, start + seqlen, device=input_ids.device)
        x = (F.embedding(input_ids, self.token_embedding.weight).to(self.dtype)
             + F.embedding(pos, self.position_embedding.weight).to(self.dtype)[None])
        x = apply_dropout(x, self.dropout, deterministic, generator)
        for i, block in enumerate(self.blocks):
            x = block(x, attention_mask, cache.layers[i] if cache is not None else None,
                      deterministic=deterministic, generator=generator)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return F.linear(x, self.vocab_matrix().to(self.dtype))

    def vocab_matrix(self) -> torch.Tensor:
        """The (V, d) output-projection parameter: the tied
        ``token_embedding.weight`` or the untied ``lm_head.weight`` (torch
        keeps both as (V, d); JAX transposes its untied kernel)."""
        if self.tie_embeddings:
            return self.token_embedding.weight
        return self.lm_head.weight

    def for_decoding(self, cache_len: int | None = None) -> GPTDecoder:
        """KV-cache decoding view of this model (JAX ``for_decoding``):
        same parameters, a cache of ``min(cache_len, block_size)``
        positions."""
        if cache_len is None:
            cache_len = self.block_size
        return GPTDecoder(self, min(cache_len, self.block_size))


@dataclass
class GPTDecoder:
    """Cached autoregressive decoding over a :class:`GPT`: prefill with
    the prompt, then one token per call, each call appending to the
    cache from :meth:`init_cache`."""

    model: GPT
    cache_len: int

    def __post_init__(self) -> None:
        if self.cache_len <= 0:
            raise ValueError("decoding requires cache_len > 0")
        if self.model.kv_cache_dtype != "model":
            raise NotImplementedError(
                "kv_cache_dtype='int8' is not yet ported to llmtrain_tpu_torch "
                "(ROADMAP.md queue A: continuous serving)"
            )
        window = self.model.sliding_window
        if window and window < self.cache_len:
            raise NotImplementedError(
                "the rolling sliding-window decode cache is not yet ported to "
                "llmtrain_tpu_torch (ROADMAP.md queue A: continuous serving)"
            )

    def init_cache(self, batch: int) -> KVCache:
        m = self.model
        dev = m.token_embedding.weight.device
        head_dim = m.d_model // m.n_heads
        shape = (batch, self.cache_len, m.n_kv_heads, head_dim)
        return KVCache(
            layers=[
                LayerKVCache(
                    torch.zeros(shape, dtype=m.dtype, device=dev),
                    torch.zeros(shape, dtype=m.dtype, device=dev),
                )
                for _ in range(m.n_layers)
            ]
        )

    def __call__(self, input_ids: torch.Tensor, cache: KVCache) -> torch.Tensor:
        return self.model(input_ids, cache=cache)


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
    "CausalSelfAttention",
    "KVCache",
    "LayerKVCache",
    "LOSS_IMPLS",
    "LayerNorm",
    "TransformerBlock",
    "apply_dropout",
    "dense_attention",
    "resolve_loss_impl",
]
