"""Mixture-of-Experts GPT adapter, ``gpt_moe`` (port of
``llmtrain_tpu/models/gpt_moe.py``): the GPT trunk with every block's MLP
replaced by :class:`~llmtrain_tpu_torch.models.moe.MoEMLP`.

Config knobs ride ``model.extra``: ``n_experts`` (required, >= 2),
``capacity_factor`` (1.25), ``moe_aux_weight`` (0.01) and
``router_top_k`` (1; 2 is GShard's second choice). The objective is CE
plus the layers' load-balance loss, folded into the per-example loss sums
in proportion to their token counts, so the trainer's token-weighted mean
is exactly ``CE + aux``. On a mesh with an ``expert`` axis each rank
holds its slice of the experts, their inputs crossing the axis by
all-to-all (models/moe.py)."""

from __future__ import annotations

from typing import Any

import torch

from ..config.schemas import RunConfig
from ..registry.models import register_model
from .base import Batch, masked_ce_components, validate_lm_batch
from .gpt import GPTAdapter
from .moe import take_aux_loss


@register_model("gpt_moe")
class GPTMoEAdapter(GPTAdapter):
    """GPT with Mixture-of-Experts MLPs."""

    known_extra_keys = GPTAdapter.known_extra_keys | frozenset(
        {"n_experts", "capacity_factor", "moe_aux_weight", "router_top_k"}
    )
    # The names the refusal of a dense config cites (models/llama.py's
    # LlamaMoEAdapter reuses the machinery).
    _moe_name = "gpt_moe"
    _dense_name = "gpt"

    def model_kwargs(self, cfg: RunConfig) -> dict[str, Any]:
        extra = cfg.model.extra
        n_experts = int(extra.get("n_experts", 0))
        if n_experts < 2:
            raise ValueError(
                f"{self._moe_name} requires model.extra.n_experts >= 2 "
                f"(got {n_experts}); use model.name {self._dense_name!r} "
                "for a dense MLP"
            )
        kw = super().model_kwargs(cfg)
        kw["moe"] = dict(
            n_experts=n_experts,
            capacity_factor=float(extra.get("capacity_factor", 1.25)),
            aux_loss_weight=float(extra.get("moe_aux_weight", 0.01)),
            router_top_k=int(extra.get("router_top_k", 1)),
        )
        return kw

    def compute_loss_components(
        self,
        model: torch.nn.Module,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        input_ids, labels, attention_mask = validate_lm_batch(batch)
        # chunked_ce and fused_ce contract the hidden states against the
        # vocab matrix outside the forward.
        chunked = model.loss_impl in ("chunked_ce", "fused_ce")
        out = model(input_ids.long(), attention_mask, deterministic=deterministic,
                    generator=generator, return_hidden=chunked)
        if chunked:
            loss_sum, tokens = self.chunked_components_from_hidden(model, out, labels,
                                                                   attention_mask)
        else:
            loss_sum, tokens = masked_ce_components(out, labels, attention_mask,
                                                    z_loss=model.z_loss)
        aux = take_aux_loss(model)
        return loss_sum + aux * tokens, tokens


__all__ = ["GPTMoEAdapter"]
