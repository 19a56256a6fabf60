"""Run metadata (``meta.json``) generation (port of ``llmtrain_tpu/utils/metadata.py``).

Parity target: reference ``src/llmtrain/utils/metadata.py`` — meta_version,
run identity, UTC timestamp, full git sha, python/platform info, argv, cwd,
config paths, distributed env snapshot, hostname, pid (metadata.py:52-67),
atomic write (metadata.py:70-81). The env snapshot captures the JAX
rendezvous variables instead of torch's.
"""

from __future__ import annotations

import json
import os
import platform
import socket
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .git import git_sha

META_VERSION = 1

# Env vars that determine multi-process topology (torch names kept for the
# K8s bootstrap contract + JAX-native names).
DISTRIBUTED_ENV_VARS = (
    "RANK",
    "WORLD_SIZE",
    "LOCAL_RANK",
    "MASTER_ADDR",
    "MASTER_PORT",
    "JOB_COMPLETION_INDEX",
    "JAX_PROCESS_ID",
    "JAX_NUM_PROCESSES",
    "JAX_COORDINATOR_ADDRESS",
    "TPU_WORKER_ID",
)


def _git_full_sha() -> str | None:
    return git_sha(short=False)


def distributed_env_snapshot() -> dict[str, str]:
    """Subset of os.environ relevant to multi-process topology."""
    return {k: os.environ[k] for k in DISTRIBUTED_ENV_VARS if k in os.environ}


def generate_meta(
    *,
    run_id: str,
    run_name: str,
    config_path: str | Path,
    resolved_config_path: str | Path | None,
) -> dict[str, Any]:
    """Assemble the ``meta.json`` payload."""
    return {
        "meta_version": META_VERSION,
        "run_id": run_id,
        "run_name": run_name,
        "created_at": datetime.now(timezone.utc).isoformat(),
        "git_sha": _git_full_sha(),
        "python_version": sys.version,
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "cwd": str(Path.cwd()),
        "config_path": str(config_path),
        "resolved_config_path": str(resolved_config_path) if resolved_config_path else None,
        "distributed_env": distributed_env_snapshot(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
    }


def write_meta_json(run_dir: str | Path, meta: dict[str, Any]) -> Path:
    """Atomically write ``meta.json`` into the run directory."""
    target = Path(run_dir) / "meta.json"
    tmp = target.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(meta, indent=2, sort_keys=False), encoding="utf-8")
    tmp.replace(target)
    return target
