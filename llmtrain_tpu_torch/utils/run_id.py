"""Deterministic, collision-safe run identifiers (port of ``llmtrain_tpu/utils/run_id.py``).

Parity target: reference ``src/llmtrain/utils/run_id.py`` — format
``{UTC %Y%m%d_%H%M%S}_{short git sha|nogit}_{slug<=40}`` (run_id.py:52-57),
lowercase slug alphabet ``[a-z0-9-_]`` (run_id.py:29-37), collision suffixes
``__01..__99`` then error (run_id.py:40-49).
"""

from __future__ import annotations

import re
from datetime import datetime, timezone
from pathlib import Path

from .git import git_sha

_MAX_SLUG_LEN = 40
_MAX_COLLISION_SUFFIX = 99
_SLUG_RE = re.compile(r"[^a-z0-9\-_]+")


def slugify_run_name(name: str) -> str:
    """Lowercase ``name`` and squash anything outside ``[a-z0-9-_]`` to ``-``."""
    slug = _SLUG_RE.sub("-", name.strip().lower())
    slug = re.sub(r"-{2,}", "-", slug).strip("-")
    if not slug:
        slug = "run"
    return slug[:_MAX_SLUG_LEN]


def _git_short_sha() -> str:
    """Short git sha of the cwd repo, or ``nogit`` outside a repo."""
    return git_sha(short=True) or "nogit"


def generate_run_id(run_name: str, output_root: str | Path) -> str:
    """Build ``{timestamp}_{sha}_{slug}``, suffixing ``__NN`` on collision."""
    timestamp = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
    base = f"{timestamp}_{_git_short_sha()}_{slugify_run_name(run_name)}"
    root = Path(output_root)
    candidate = base
    if not (root / candidate).exists():
        return candidate
    for i in range(1, _MAX_COLLISION_SUFFIX + 1):
        candidate = f"{base}__{i:02d}"
        if not (root / candidate).exists():
            return candidate
    raise RuntimeError(
        f"Could not find a free run id after {_MAX_COLLISION_SUFFIX} attempts for {base!r}"
    )
