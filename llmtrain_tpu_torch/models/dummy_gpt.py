"""Tiny dummy model adapter, the fast fake backend for tests and the
``dummy_smoke``/``example`` presets (port of
``llmtrain_tpu/models/dummy_gpt.py``).

embed → one gelu MLP with a residual → LayerNorm → lm_head, registered as
``dummy_gpt``, with JAX's clamps (vocab 128 when unset, d_model capped at
64). The layers follow flax's semantics: tanh-approximate gelu, LayerNorm
with epsilon 1e-6 and the one-pass variance, f32 throughout (the flax
module sets no dtype). Initialization follows flax's distributions
(embedding N(0, 1/d), kernels LeCun truncated normal, zero biases) from a
``torch.Generator``; the bits differ from JAX's, as for the GPT.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schemas import RunConfig
from ..registry.models import register_model
from .base import Batch, ModelAdapter, lm_loss_components
from .gpt import LayerNorm

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# ``truncated_normal`` variance scaling divides by it.
_TRUNC_STD = 0.87962566103423978


class TinyLM(nn.Module):
    """The flax ``_TinyLM``: logits (B, T, V) in f32."""

    dtype = torch.float32
    param_dtype = torch.float32
    z_loss = 0.0

    def __init__(self, vocab_size: int, d_model: int) -> None:
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.embed = nn.Embedding(vocab_size, d_model)
        self.mlp_in = nn.Linear(d_model, 2 * d_model)
        self.mlp_out = nn.Linear(2 * d_model, d_model)
        self.ln_f = LayerNorm(d_model, dtype=torch.float32, param_dtype=torch.float32)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: the embedding N(0, 1/d), each kernel LeCun
        truncated normal (std sqrt(1/fan_in), cut at two), zero biases,
        unit LayerNorm scale."""
        nn.init.normal_(self.embed.weight, 0.0, 1.0 / math.sqrt(self.d_model),
                        generator=generator)
        for layer in (self.mlp_in, self.mlp_out, self.lm_head):
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        del attention_mask, deterministic, generator
        x = self.embed(input_ids.long())
        h = F.gelu(self.mlp_in(x), approximate="tanh")
        x = x + self.mlp_out(h)
        return self.lm_head(self.ln_f(x))


@register_model("dummy_gpt")
class DummyGPTAdapter(ModelAdapter):
    """Tiny adapter for smoke tests."""

    known_extra_keys = frozenset()

    def build_model(self, cfg: RunConfig, device: torch.device | None = None) -> TinyLM:
        vocab_size = cfg.model.vocab_size or 128
        d_model = min(cfg.model.d_model or 128, 64)
        model = TinyLM(vocab_size=vocab_size, d_model=d_model)
        if device is not None:
            model = model.to(device)
        generator = torch.Generator(device=model.embed.weight.device)
        generator.manual_seed(cfg.run.seed)
        model.init_weights(generator)
        return model.eval()

    def build_tokenizer(self, cfg: RunConfig) -> Any | None:
        del cfg
        return None

    def compute_loss_components(
        self,
        model: TinyLM,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return lm_loss_components(model, batch, generator=generator,
                                  deterministic=deterministic)


__all__ = ["DummyGPTAdapter", "TinyLM"]
