"""Llama-family decoder in PyTorch (port of ``llmtrain_tpu/models/llama.py``).

RMSNorm in place of LayerNorm, rotary position embeddings in place of
learned ones, a gated MLP (SwiGLU, or Gemma's GeGLU) and an untied head
by default. Everything else is the GPT machinery of models/gpt.py:
attention is its :class:`CausalSelfAttention` (``use_bias=False``,
``rope=True``), so there is one attention, one decode cache (the linear
cache, the rolling ring under a sliding window, the int8 cache) and one
paged path in the port, as in JAX; the loss dispatch (``dense``,
``chunked_ce``, ``fused_ce``) and the decoding views are GPT's.

Knobs of the family (JAX field names):

* ``qkv_bias`` — Qwen2: a bias on the q/k/v projections only;
* ``mlp_act`` ``gelu_tanh``, ``norm_offset``, ``embed_scale`` — Gemma:
  ``gelu(approximate='tanh')`` in the MLP, norms that multiply by
  ``1 + scale`` over a zero-initialized scale, and input embeddings times
  sqrt(d_model), the factor first rounded to the activation dtype;
* ``sliding_window`` — Mistral: each query attends its last W keys (the
  windowed flash kernel in training, the rolling ring in decoding);
* ``moe`` — Mixtral (``llama_moe``): SwiGLU experts (models/moe.py).

RMSNorm keeps f32 statistics with eps 1e-6 by default. The fused
add+LayerNorm kernel is LayerNorm-shaped and the family refuses it, as
JAX's adapter does.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schemas import RunConfig
from ..registry.models import register_model
from .gpt import (
    _INIT_STD,
    CausalSelfAttention,
    GPT,
    GPTAdapter,
    _axis_split,
    _dense_fn,
    _group,
    _row_blocks,
    _row_parallel_fn,
    apply_dropout,
    embed,
    mlp_rows,
)
from .moe import MoEMLP, fill_constant, fill_normal

MLP_ACTS = ("silu", "gelu_tanh")


class RMSNorm(nn.Module):
    """Root-mean-square norm, scale only, f32 statistics (JAX ``RMSNorm``):
    ``x * rsqrt(mean(x^2) + eps) * scale``, or ``* (1 + scale)`` with
    ``offset`` (Gemma; the scale then starts at zero), output in
    ``dtype``."""

    def __init__(self, d: int, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 eps: float = 1e-6, offset: bool = False) -> None:
        super().__init__()
        init = torch.zeros if offset else torch.ones
        self.weight = nn.Parameter(init(d, dtype=param_dtype))
        self.eps = eps
        self.offset = offset
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        mult = self.weight.float()
        if self.offset:
            mult = 1.0 + mult
        return (norm * mult).to(self.dtype)


class LlamaBlock(nn.Module):
    """Pre-norm block: ``attn_norm`` → attention → residual, ``mlp_norm``
    → gated MLP (``mlp_gate``, ``mlp_up``, ``mlp_down``, bias-free) or the
    SwiGLU experts (``moe_mlp``) → dropout → residual."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, dropout: float = 0.0, rms_norm_eps: float = 1e-6,
                 norm_offset: bool = False, mlp_act: str = "silu", qkv_bias: bool = False,
                 moe: dict[str, Any] | None = None, matmul_precision: str = "f32",
                 tensor_parallel: int = 1, sequence_parallel: int = 1,
                 expert_parallel: int = 1, **attn_kw: Any) -> None:
        super().__init__()
        self.matmul_precision = matmul_precision
        self.sp = sequence_parallel
        if mlp_act not in MLP_ACTS:
            raise ValueError(f"mlp_act {mlp_act!r} unknown; expected 'silu' or 'gelu_tanh'")
        self.dtype = dtype
        self.dropout = dropout
        self.mlp_act = mlp_act
        norm_kw = dict(dtype=dtype, param_dtype=param_dtype, eps=rms_norm_eps,
                       offset=norm_offset)
        self.attn_norm = RMSNorm(d_model, **norm_kw)
        self.attn = CausalSelfAttention(d_model, n_heads, dtype=dtype, param_dtype=param_dtype,
                                        dropout=dropout, use_bias=False,
                                        qkv_bias=qkv_bias or None, rope=True,
                                        matmul_precision=matmul_precision,
                                        tensor_parallel=tensor_parallel,
                                        sequence_parallel=sequence_parallel, **attn_kw)
        self.mlp_norm = RMSNorm(d_model, **norm_kw)
        if moe:
            self.moe_mlp = MoEMLP(d_model, d_ff, dtype=dtype, param_dtype=param_dtype,
                                  mlp_type="swiglu", matmul_precision=matmul_precision,
                                  tensor_parallel=tensor_parallel,
                                  expert_parallel=expert_parallel,
                                  sequence_parallel=sequence_parallel, **moe)
        else:
            # The mlp dim splits over the tensor axis where it divides.
            self.mlp_tp = tensor_parallel if d_ff % tensor_parallel == 0 else 1
            kw = dict(bias=False, dtype=param_dtype)
            self.mlp_gate = nn.Linear(d_model, d_ff // self.mlp_tp, **kw)
            self.mlp_up = nn.Linear(d_model, d_ff // self.mlp_tp, **kw)
            self.mlp_down = nn.Linear(d_ff // self.mlp_tp, d_model, **kw)

    def _mlp(self) -> Any:
        """The MLP as a function of its input, its kernels cast once."""
        if hasattr(self, "moe_mlp"):
            return self.moe_mlp
        mode = self.matmul_precision
        group = _group("tensor", self.mlp_tp)
        gate = _dense_fn(self.mlp_gate, self.dtype, mode)
        up = _dense_fn(self.mlp_up, self.dtype, mode)
        down = _row_parallel_fn(self.mlp_down, self.dtype, mode, group)
        if self.mlp_act == "silu":
            mlp = lambda h: down(F.silu(gate(h)) * up(h))  # noqa: E731
        else:
            mlp = lambda h: down(F.gelu(gate(h), approximate="tanh") * up(h))  # noqa: E731
        if group is None:
            return mlp
        from ..parallel.collectives import copy_to

        return lambda h: mlp(copy_to(h, group))

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), attention_mask, deterministic=deterministic,
                          generator=generator)
        h = self._mlp()(self.mlp_norm(x))
        return x + apply_dropout(h, self.dropout, deterministic, generator,
                                 _axis_split(1, "sequence", self.sp))

    def decode_rows(self, x: torch.Tensor, shape: tuple[int, int], positions: torch.Tensor,
                    write_read: Any, rows: int | None) -> torch.Tensor:
        """The block on the decode paths (models/gpt.py
        :meth:`TransformerBlock.decode_rows`)."""
        h = _row_blocks(self.attn_norm, x)
        x = x + self.attn.decode_rows(h, shape, positions, write_read, rows)
        return x + mlp_rows(self, self._mlp(), _row_blocks(self.mlp_norm, x), shape)


class Llama(GPT):
    """Llama-family decoder-only language model. A :class:`GPT` in every
    method but its layers: the decoding views, the loss hooks and
    ``vocab_matrix`` are GPT's, over RMSNorm blocks, rotary positions and
    the final ``norm_f``."""

    def __init__(self, *, tie_embeddings: bool = False, embed_scale: bool = False,
                 **kw: Any) -> None:
        """GPT's constructor (its keywords) with the family's knobs:
        ``rms_norm_eps``, ``qkv_bias``, ``mlp_act`` and ``norm_offset`` go to
        the blocks (:meth:`_build_layers`), ``embed_scale`` to
        :meth:`_embed`; the head is untied by default."""
        super().__init__(tie_embeddings=tie_embeddings, **kw)
        self.embed_scale = embed_scale

    def _build_layers(self, d_ff: int, block_kw: dict[str, Any], *, rope: bool,
                      rms_norm_eps: float = 1e-6, qkv_bias: bool = False,
                      mlp_act: str = "silu", norm_offset: bool = False) -> None:
        """RMSNorm blocks with rotary attention (always: ``rope`` is GPT's
        switch) and the final ``norm_f``; no position embedding."""
        if self.fused_norm:
            raise ValueError("the llama family's norms are RMSNorm: no fused_norm")
        d = self.d_model
        self.blocks = nn.ModuleList(
            LlamaBlock(d, self.n_heads, d_ff, rms_norm_eps=rms_norm_eps,
                       norm_offset=norm_offset, mlp_act=mlp_act, qkv_bias=qkv_bias, **block_kw)
            for _ in range(self.n_layers)
        )
        self.norm_f = RMSNorm(d, dtype=self.dtype, param_dtype=self.param_dtype,
                              eps=rms_norm_eps, offset=norm_offset)

    def init_plan(self) -> list[tuple[str, Any]]:
        """The JAX initialization as (parameter name, fill) in draw order
        (``GPT.init_plan``): N(0, 0.02) embeddings and projections,
        N(0, 0.02/sqrt(2·n_layers)) for ``out_proj`` and ``mlp_down``, zero
        q/k/v biases, norm scales at one (zero under ``norm_offset``); the
        experts by :meth:`MoEMLP.init_plan`."""
        residual_std = _INIT_STD / math.sqrt(2 * self.n_layers)
        plan = []
        for mod_name, module in self.named_modules():
            if isinstance(module, MoEMLP):
                plan += [(f"{mod_name}.{n}", fill)
                         for n, fill in module.init_plan(self.n_layers)]
            elif isinstance(module, RMSNorm):
                plan.append((f"{mod_name}.weight", fill_constant(0.0 if module.offset else 1.0)))
        for name, _ in self.named_parameters():
            if ".moe_mlp." in name or "norm" in name.split(".")[-2]:
                continue
            if name.endswith("bias"):
                plan.append((name, fill_constant(0.0)))
            else:
                std = residual_std if ("out_proj" in name or "mlp_down" in name) else _INIT_STD
                plan.append((name, fill_normal(std)))
        return plan

    def _embed(self, input_ids: torch.Tensor, positions: torch.Tensor, *,
               decode: bool = False) -> torch.Tensor:
        """Token embeddings in the compute dtype (positions enter through
        RoPE inside attention), times sqrt(d_model) under ``embed_scale``:
        the factor is cast to the activation dtype before the product, as
        HF Gemma and JAX do."""
        x = self._token_embed(input_ids, F.embedding if decode else embed)
        if self.embed_scale:
            x = x * torch.tensor(self.d_model**0.5, dtype=x.dtype, device=x.device)
        return x

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_f(x)


@register_model("llama")
class LlamaAdapter(GPTAdapter):
    """Adapter for the Llama family: GPT's validation and loss machinery
    (the module keeps GPT's top-level names and loss attributes), then the
    family's own checks."""

    known_extra_keys = GPTAdapter.known_extra_keys | frozenset({"rope_theta", "rms_norm_eps"})
    _model_class = Llama

    def model_kwargs(self, cfg: RunConfig) -> dict[str, Any]:
        if cfg.model.extra.get("fused_norm"):
            # The fused kernels are LayerNorm-shaped; the family's norms
            # are RMSNorm.
            raise ValueError(
                "model.extra.fused_norm is not supported by the llama "
                "family (RMSNorm blocks); it is a gpt-family knob"
            )
        kw = super().model_kwargs(cfg)  # the shared validation
        kw.pop("fused_norm")
        rope_theta = float(cfg.model.extra.get("rope_theta", 10000.0))
        if rope_theta <= 0:
            raise ValueError(f"model.extra.rope_theta must be > 0, got {rope_theta}")
        rms_norm_eps = float(cfg.model.extra.get("rms_norm_eps", 1e-6))
        if rms_norm_eps <= 0:
            raise ValueError(f"model.extra.rms_norm_eps must be > 0, got {rms_norm_eps}")
        if (cfg.model.d_model // cfg.model.n_heads) % 2 != 0:
            raise ValueError(
                "RoPE needs an even head dim: d_model/n_heads = "
                f"{cfg.model.d_model // cfg.model.n_heads}"
            )
        # The schema's tie_embeddings default (true, the GPT convention) is
        # wrong for this family: a config that does not set it gets an
        # untied head; a value that is set wins either way.
        kw["tie_embeddings"] = (cfg.model.tie_embeddings
                                if "tie_embeddings" in cfg.model.model_fields_set else False)
        kw.update(rope_theta=rope_theta, rms_norm_eps=rms_norm_eps)
        return kw




from .gpt_moe import GPTMoEAdapter as _GPTMoEAdapter  # noqa: E402


@register_model("llama_moe")
class LlamaMoEAdapter(_GPTMoEAdapter, LlamaAdapter):
    """The Mixtral layout: the llama family with SwiGLU experts. The MRO
    composes the two: ``GPTMoEAdapter.model_kwargs`` adds the experts
    over ``LlamaAdapter.model_kwargs``, and its loss folds in the aux;
    with ``model.extra.sliding_window`` this is Mixtral."""

    known_extra_keys = _GPTMoEAdapter.known_extra_keys | LlamaAdapter.known_extra_keys
    _moe_name = "llama_moe"
    _dense_name = "llama"


__all__ = ["Llama", "LlamaAdapter", "LlamaBlock", "LlamaMoEAdapter", "RMSNorm"]
