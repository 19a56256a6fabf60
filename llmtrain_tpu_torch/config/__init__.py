"""Config system: strict Pydantic schemas + YAML loader (copies of the
JAX package's, with ``run.device`` also accepting ``"cuda"``)."""

from .loader import (
    ConfigLoadError,
    load_and_validate_config,
    load_yaml_config,
    resolve_config_path,
)
from .schemas import RunConfig

__all__ = [
    "ConfigLoadError",
    "RunConfig",
    "load_and_validate_config",
    "load_yaml_config",
    "resolve_config_path",
]
