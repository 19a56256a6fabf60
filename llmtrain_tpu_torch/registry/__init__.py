"""Plugin registry with deterministic initialization (port of
``llmtrain_tpu/registry/__init__.py``). This slice registers the dense
GPT only; the data registry comes with the training slice."""

from __future__ import annotations

import importlib

from .models import RegistryError, get_model_adapter, register_model

_PLUGIN_MODULES = ("llmtrain_tpu_torch.models.gpt",)


def initialize_registries() -> None:
    """Import every built-in plugin module exactly once."""
    for module in _PLUGIN_MODULES:
        importlib.import_module(module)


__all__ = [
    "RegistryError",
    "get_model_adapter",
    "initialize_registries",
    "register_model",
]
