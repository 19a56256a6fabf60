"""Gemma-family adapter (port of ``llmtrain_tpu/models/gemma.py``): the
Llama stack with Gemma's conventions: a GeGLU MLP (tanh GELU), norms that
multiply by ``1 + scale`` over a zero-initialized scale, input embeddings
scaled by sqrt(d_model), and a tied head unless ``tie_embeddings`` is set.
The head dim is ``d_model // n_heads``, as everywhere in the package."""

from __future__ import annotations

from typing import Any

from ..config.schemas import RunConfig
from ..registry.models import register_model
from .llama import LlamaAdapter


@register_model("gemma")
class GemmaAdapter(LlamaAdapter):
    """Adapter for the Gemma family (GeGLU + offset norms + scaled embed)."""

    def model_kwargs(self, cfg: RunConfig) -> dict[str, Any]:
        kw = super().model_kwargs(cfg)  # the whole llama validation
        kw.update(mlp_act="gelu_tanh", norm_offset=True, embed_scale=True)
        if "tie_embeddings" not in cfg.model.model_fields_set:
            kw["tie_embeddings"] = True
        return kw


__all__ = ["GemmaAdapter"]
