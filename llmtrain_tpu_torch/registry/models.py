"""Model-adapter registry (port of ``llmtrain_tpu/registry/models.py``):
name → adapter class, duplicate registration and unknown lookups raise
listing the available names."""

from __future__ import annotations

from typing import Callable, TypeVar

from ..models.base import ModelAdapter


class RegistryError(Exception):
    """Raised on duplicate registration or unknown lookup."""


_MODEL_ADAPTERS: dict[str, type[ModelAdapter]] = {}

T = TypeVar("T", bound=type[ModelAdapter])


def register_model(name: str) -> Callable[[T], T]:
    def decorator(cls: T) -> T:
        if name in _MODEL_ADAPTERS:
            raise RegistryError(
                f"Model adapter {name!r} is already registered. "
                f"Available: {sorted(_MODEL_ADAPTERS)}"
            )
        _MODEL_ADAPTERS[name] = cls
        return cls

    return decorator


def get_model_adapter(name: str) -> type[ModelAdapter]:
    try:
        return _MODEL_ADAPTERS[name]
    except KeyError:
        raise RegistryError(
            f"Unknown model adapter {name!r}. Available in llmtrain_tpu_torch: "
            f"{sorted(_MODEL_ADAPTERS)}"
        ) from None

