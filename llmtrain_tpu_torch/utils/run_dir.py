"""Run-directory creation and atomic resolved-config snapshots (port of ``llmtrain_tpu/utils/run_dir.py``).

Parity target: reference ``src/llmtrain/utils/run_dir.py`` — creates
``{root}/{run_id}/`` with ``exist_ok=False`` plus ``logs/``, cleans up a
partially-created dir on failure (run_dir.py:22-28), atomic config write via
``.tmp`` + ``replace`` (run_dir.py:37-45).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import yaml


def create_run_directory(root_dir: str | Path, run_id: str) -> Path:
    """Create ``{root_dir}/{run_id}`` (must not exist) with a ``logs/`` subdir."""
    root = Path(root_dir)
    root.mkdir(parents=True, exist_ok=True)
    run_dir = root / run_id
    run_dir.mkdir(exist_ok=False)
    try:
        (run_dir / "logs").mkdir()
    except OSError:
        shutil.rmtree(run_dir, ignore_errors=True)
        raise
    return run_dir


def write_resolved_config(run_dir: str | Path, resolved: dict[str, Any]) -> Path:
    """Atomically write the fully-resolved config to ``config.yaml``."""
    target = Path(run_dir) / "config.yaml"
    tmp = target.with_suffix(".yaml.tmp")
    tmp.write_text(yaml.safe_dump(resolved, sort_keys=False), encoding="utf-8")
    tmp.replace(target)
    return target
