"""Model-adapter contract and the language-model losses (port of
``llmtrain_tpu/models/base.py``).

An adapter builds the model and its tokenizer from a config and defines
the training loss. Where JAX passes ``(model, params)`` the port passes
the ``nn.Module``, which holds its parameters; dropout randomness comes
from an explicit ``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from ..config.schemas import RunConfig

Batch = dict[str, torch.Tensor]
Metrics = dict[str, torch.Tensor]


class ModelAdapter(ABC):
    """Builds a torch model + tokenizer from a config and defines its loss."""

    # Extra-dict keys this adapter understands. None disables the check
    # for plugins with free-form extras.
    known_extra_keys: frozenset[str] | None = None

    @abstractmethod
    def build_model(self, cfg: RunConfig, device: torch.device | None = None) -> torch.nn.Module:
        """Construct the model (parameters in ``model.param_dtype`` on
        ``device``, initialized from ``run.seed``)."""

    @abstractmethod
    def build_tokenizer(self, cfg: RunConfig) -> Any | None:
        """Construct the tokenizer, or None for models that need none."""

    @staticmethod
    def _positive_extra(cfg: RunConfig, key: str, default: int) -> int:
        """Validated ``model.extra`` integer knob (>= 1), shared by adapters."""
        value = int(cfg.model.extra.get(key, default))
        if value < 1:
            raise ValueError(f"model.extra.{key} must be >= 1, got {value}")
        return value

    def compute_loss(
        self,
        model: torch.nn.Module,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, Metrics]:
        """``(scalar loss, metrics)``: the token-weighted mean of
        :meth:`compute_loss_components` (one forward)."""
        comps = self.compute_loss_components(
            model, batch, generator=generator, deterministic=deterministic
        )
        if comps is None:
            raise NotImplementedError(
                f"{type(self).__name__} must implement compute_loss or compute_loss_components"
            )
        loss_sum, tokens = comps
        loss = loss_sum.sum() / tokens.sum().clamp_min(1.0)
        return loss, {"loss": loss}

    def compute_loss_components(
        self,
        model: torch.nn.Module,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Optional per-example ``(loss_sum, token_count)`` of shape (B,);
        the trainer derives the scalar loss as sum/sum. None makes it fall
        back to :meth:`compute_loss`."""
        del model, batch, generator, deterministic
        return None


_INTEGER_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def validate_lm_batch(batch: Batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The JAX checks: 2-D integer input_ids/labels of equal shape, seq
    len >= 2, and an optional bool or integer attention_mask of the same
    shape."""
    input_ids = batch["input_ids"]
    labels = batch["labels"]
    attention_mask = batch.get("attention_mask")
    if input_ids.dim() != 2 or labels.dim() != 2:
        raise ValueError(
            f"Expected input_ids and labels to be 2D (B, T); "
            f"got {tuple(input_ids.shape)} and {tuple(labels.shape)}."
        )
    if input_ids.shape != labels.shape:
        raise ValueError(
            "Expected input_ids and labels to have the same shape; "
            f"got {tuple(input_ids.shape)} vs {tuple(labels.shape)}."
        )
    if input_ids.dtype not in _INTEGER_DTYPES or labels.dtype not in _INTEGER_DTYPES:
        raise ValueError(
            f"Expected integer input_ids and labels; got {input_ids.dtype} and {labels.dtype}."
        )
    if input_ids.shape[1] < 2:
        raise ValueError("Expected sequence length >= 2 for next-token loss.")
    if attention_mask is not None:
        if attention_mask.dim() != 2 or attention_mask.shape != input_ids.shape:
            raise ValueError(
                "Expected attention_mask to match input_ids shape; "
                f"got {tuple(attention_mask.shape)} vs {tuple(input_ids.shape)}."
            )
        if attention_mask.dtype not in _INTEGER_DTYPES and attention_mask.dtype != torch.bool:
            raise ValueError(f"Expected bool or integer attention_mask; got {attention_mask.dtype}.")
    return input_ids, labels, attention_mask


def lm_loss_components(
    model: torch.nn.Module,
    batch: Batch,
    *,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared LM forward → per-example (loss_sum, token_count); honours
    the model's ``z_loss``."""
    input_ids, labels, attention_mask = validate_lm_batch(batch)
    logits = model(
        input_ids.long(), attention_mask, deterministic=deterministic, generator=generator
    )
    return masked_ce_components(
        logits, labels, attention_mask, z_loss=getattr(model, "z_loss", 0.0)
    )


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, attention_mask: torch.Tensor | None
) -> torch.Tensor:
    """Position-wise CE with a mask-aware mean (labels already shifted)."""
    loss_sum, tokens = masked_ce_components(logits, labels, attention_mask)
    return loss_sum.sum() / tokens.sum().clamp_min(1.0)


def masked_ce_components(
    logits: torch.Tensor,
    labels: torch.Tensor,
    attention_mask: torch.Tensor | None,
    *,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example ``(loss_sum, token_count)`` of shape (B,), CE in f32;
    ``z_loss > 0`` adds ``z_loss * log(Z)^2`` per token. The mask has
    boolean semantics (segment ids > 1 are not weights)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    per_token = lse - label_logit
    if z_loss > 0.0:
        per_token = per_token + z_loss * lse.square()
    if attention_mask is None:
        mask = torch.ones_like(per_token)
    else:
        mask = (attention_mask != 0).float()
    return (per_token * mask).sum(dim=-1), mask.sum(dim=-1)


__all__ = [
    "Batch",
    "ModelAdapter",
    "lm_loss_components",
    "masked_ce_components",
    "masked_cross_entropy",
    "validate_lm_batch",
]
