"""Model-adapter contract (port of ``llmtrain_tpu/models/base.py``), reduced
to the surface ``generate`` and ``serve`` use: build the model and its
tokenizer from a config. Losses come with the training slice.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from ..config.schemas import RunConfig


class ModelAdapter(ABC):
    """Builds a torch model + tokenizer from a config."""

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


__all__ = ["ModelAdapter"]
