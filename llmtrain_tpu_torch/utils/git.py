"""Shared git-introspection helper (port of ``llmtrain_tpu/utils/git.py``)."""

from __future__ import annotations

import subprocess


def git_sha(*, short: bool) -> str | None:
    """Current HEAD sha of the cwd repo, or ``None`` outside a repo."""
    cmd = ["git", "rev-parse"] + (["--short"] if short else []) + ["HEAD"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=5, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None
