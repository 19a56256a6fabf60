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
    """The registered data module ``name``. JAX's ``hf_text`` is refused
    with ``NotImplementedError`` (a config error): it reads from the
    Hugging Face hub, a download, so no ROADMAP.md item queues it. Any
    other unknown name raises :class:`RegistryError`."""
    try:
        return _DATA_MODULES[name]
    except KeyError:
        if name == "hf_text":
            raise NotImplementedError(
                "data module 'hf_text' reads from the Hugging Face hub, a download; "
                "it is not queued for llmtrain_tpu_torch (ROADMAP.md queue A: smoke "
                "presets and offline data); use local_text or mixed_text over local files"
            ) from None
        raise RegistryError(
            f"Unknown data module {name!r}. Available: {sorted(_DATA_MODULES)}"
        ) from None


__all__ = ["get_data_module", "register_data_module"]
