"""Data-module registry (port of ``llmtrain_tpu/registry/data.py``)."""

from __future__ import annotations

from typing import Callable, TypeVar

from ..data.base import DataModule
from .models import RegistryError

_DATA_MODULES: dict[str, type[DataModule]] = {}

T = TypeVar("T", bound=type[DataModule])


def register_data_module(name: str) -> Callable[[T], T]:
    def decorator(cls: T) -> T:
        if name in _DATA_MODULES:
            raise RegistryError(
                f"Data module {name!r} is already registered. Available: {sorted(_DATA_MODULES)}"
            )
        _DATA_MODULES[name] = cls
        return cls

    return decorator


def get_data_module(name: str) -> type[DataModule]:
    try:
        return _DATA_MODULES[name]
    except KeyError:
        raise RegistryError(
            f"Unknown data module {name!r}. Available: {sorted(_DATA_MODULES)}"
        ) from None


__all__ = ["get_data_module", "register_data_module"]
