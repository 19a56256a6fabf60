"""Plugin registries with deterministic initialization (port of
``llmtrain_tpu/registry/__init__.py``): every model family of the JAX
package, and the ``local_text``, ``mixed_text`` and ``dummy_text`` data
modules."""

from __future__ import annotations

import importlib

from .data import get_data_module, register_data_module
from .models import RegistryError, get_model_adapter, register_model

_PLUGIN_MODULES = (
    "llmtrain_tpu_torch.models.dummy_gpt",
    "llmtrain_tpu_torch.models.gpt",
    "llmtrain_tpu_torch.models.gpt_moe",
    "llmtrain_tpu_torch.models.gpt_pipeline",
    "llmtrain_tpu_torch.models.llama",
    "llmtrain_tpu_torch.models.qwen2",
    "llmtrain_tpu_torch.models.gemma",
    "llmtrain_tpu_torch.data.local_text",
    "llmtrain_tpu_torch.data.mixed_text",
    "llmtrain_tpu_torch.data.dummy_text",
)


def initialize_registries() -> None:
    """Import every built-in plugin module exactly once."""
    for module in _PLUGIN_MODULES:
        importlib.import_module(module)


__all__ = [
    "RegistryError",
    "get_data_module",
    "register_data_module",
    "get_model_adapter",
    "initialize_registries",
    "register_model",
]
