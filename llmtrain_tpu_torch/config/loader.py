"""YAML → validated ``RunConfig`` loading (the port's copy of
``llmtrain_tpu/config/loader.py``).

Parity target: reference ``src/llmtrain/config/loader.py`` — safe_load, a
structured ``ConfigLoadError(message, details, errors)``, rejection of
non-mapping top level, relative paths resolved against cwd.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import yaml
from pydantic import ValidationError

from .schemas import RunConfig


class ConfigLoadError(Exception):
    """Raised when a config file cannot be read, parsed, or validated.

    Carries structured fields so the CLI can render machine-readable JSON
    errors (reference loader.py:14-21, cli.py:63-76).
    """

    def __init__(
        self,
        message: str,
        *,
        details: str | None = None,
        errors: list[dict[str, Any]] | None = None,
    ) -> None:
        super().__init__(message)
        self.message = message
        self.details = details
        self.errors = errors or []


def resolve_config_path(path: str | Path) -> Path:
    """Resolve ``path`` against the current working directory (loader.py:31)."""
    p = Path(path)
    if not p.is_absolute():
        p = Path.cwd() / p
    return p.resolve()


def load_yaml_config(path: str | Path) -> dict[str, Any]:
    """Read and parse a YAML mapping from ``path``."""
    resolved = resolve_config_path(path)
    if not resolved.is_file():
        raise ConfigLoadError(
            f"Config file not found: {resolved}",
            details="Provide an existing YAML file via --config.",
        )
    try:
        raw_text = resolved.read_text(encoding="utf-8")
    except OSError as exc:
        raise ConfigLoadError(f"Config file could not be read: {resolved}", details=str(exc))
    try:
        parsed = yaml.safe_load(raw_text)
    except yaml.YAMLError as exc:
        raise ConfigLoadError(f"Config file is not valid YAML: {resolved}", details=str(exc))
    if parsed is None:
        parsed = {}
    if not isinstance(parsed, dict):
        raise ConfigLoadError(
            f"Config root must be a mapping, got {type(parsed).__name__}: {resolved}",
            details="Top-level YAML must be a key/value mapping of config sections.",
        )
    return parsed


def load_and_validate_config(path: str | Path) -> tuple[RunConfig, dict[str, Any], dict[str, Any]]:
    """Load YAML and validate into ``RunConfig``.

    Returns ``(config, raw_dict, resolved_dict)`` where ``resolved_dict`` is
    the fully-materialized config including defaults (loader.py:48-65).
    """
    raw = load_yaml_config(path)
    try:
        cfg = RunConfig.model_validate(raw)
    except ValidationError as exc:
        errors = [
            {
                "loc": ".".join(str(part) for part in err.get("loc", ())),
                "msg": err.get("msg", ""),
                "type": err.get("type", ""),
            }
            for err in exc.errors()
        ]
        raise ConfigLoadError(
            f"Config validation failed with {exc.error_count()} error(s).",
            details=str(path),
            errors=errors,
        )
    return cfg, raw, cfg.model_dump()
