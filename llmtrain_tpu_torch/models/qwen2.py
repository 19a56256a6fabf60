"""Qwen2-family adapter (port of ``llmtrain_tpu/models/qwen2.py``): the
Llama stack with a bias on the q/k/v projections (and only there) and a
RoPE base of 1e6 unless ``model.extra.rope_theta`` is set."""

from __future__ import annotations

from typing import Any

from ..config.schemas import RunConfig
from ..registry.models import register_model
from .llama import LlamaAdapter


@register_model("qwen2")
class Qwen2Adapter(LlamaAdapter):
    """Adapter for the Qwen2 family (llama + qkv biases + 1e6 rope base)."""

    def model_kwargs(self, cfg: RunConfig) -> dict[str, Any]:
        kw = super().model_kwargs(cfg)  # the whole llama validation
        kw["qkv_bias"] = True
        if "rope_theta" not in cfg.model.extra:
            kw["rope_theta"] = 1_000_000.0
        return kw


__all__ = ["Qwen2Adapter"]
