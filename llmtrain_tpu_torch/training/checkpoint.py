"""Checkpoint read side (port of ``llmtrain_tpu/training/checkpoint.py``).

The JAX trainer writes one ``step_NNNNNN.ckpt`` per saved step: a flax
msgpack payload (``checkpoint_version``, ``step``, ``params``,
``opt_state``, ``config_yaml``), a ``.sha256`` sidecar, and a
``step_NNNNNN.manifest.json`` commit record listing every file with its
size and digest. This module reads that layout without flax:

* :func:`msgpack_restore` decodes flax's msgpack — ndarrays are ext code 1
  holding ``(shape, dtype name, C-order bytes)``, numpy scalars ext code 3,
  oversized arrays split into ``__msgpack_chunked_array__`` dicts;
  ``bfloat16`` leaves become torch bfloat16 tensors (numpy has no such
  dtype), every other array stays numpy;
* :func:`resolve_resume_path` resolves a ``--from`` spec (file, dir →
  newest valid, run id → ``{root}/{id}/checkpoints``) exactly as JAX does;
* :func:`load_inference_params` verifies the payload, warns when its
  stored config differs from the current one, and loads the params into a
  model through the weight carry-over (interop/flax_params.py).

Read-only: where JAX adopts an unmanifested legacy checkpoint by writing
its manifest, this reader selects it without writing anything.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Any

import msgpack
import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{6,})\.ckpt$")
_MANIFEST_RE = re.compile(r"^step_(\d{6,})\.manifest\.json$")
_REQUIRED_KEYS = {"checkpoint_version", "step", "params", "opt_state", "config_yaml"}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class CheckpointError(Exception):
    """Raised for malformed or missing checkpoints."""


def _ndarray(data: bytes) -> np.ndarray | torch.Tensor:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(blob: bytes) -> Any:
    """Decode a ``flax.serialization.msgpack_serialize`` payload."""
    return _unchunk(msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False))


def sidecar_path(ckpt: Path) -> Path:
    """``step_NNNNNN.ckpt`` → its ``step_NNNNNN.ckpt.sha256`` sidecar."""
    return ckpt.with_name(ckpt.name + ".sha256")


def manifest_path(ckpt: Path) -> Path:
    """``step_NNNNNN.ckpt`` → its ``step_NNNNNN.manifest.json`` commit record."""
    return ckpt.with_name(ckpt.name[: -len(".ckpt")] + ".manifest.json")


def read_manifest(ckpt: Path) -> dict[str, Any] | None:
    """The parsed commit manifest next to ``ckpt``, or None when absent or
    unparseable."""
    try:
        data = json.loads(manifest_path(Path(ckpt)).read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def _read_sidecar_digest(ckpt: Path) -> str | None:
    try:
        first = sidecar_path(ckpt).read_text(encoding="utf-8").split()
    except OSError:
        return None
    return first[0].lower() if first else None


def _manifest_files_ok(directory: Path, manifest: dict[str, Any]) -> bool:
    """Every listed file exists with the recorded size and digest;
    malformed manifests fail closed."""
    try:
        files = manifest.get("files")
        if not isinstance(files, list) or not files:
            return False
        for entry in files:
            if not isinstance(entry, dict):
                return False
            name = entry.get("name")
            if not isinstance(name, str) or "/" in name or name.startswith("."):
                return False
            try:
                blob = (directory / name).read_bytes()
            except OSError:
                return False
            size = entry.get("bytes")
            if size is not None and len(blob) != int(size):
                return False
            digest = entry.get("sha256")
            if digest is not None and hashlib.sha256(blob).hexdigest() != str(digest).lower():
                return False
    except (TypeError, ValueError):
        return False
    return True


def _verify_file(path: Path) -> bool:
    """Sidecar digest when present, deep parse otherwise."""
    try:
        blob = path.read_bytes()
    except OSError:
        return False
    expected = _read_sidecar_digest(path)
    if expected is not None:
        return hashlib.sha256(blob).hexdigest() == expected
    try:
        payload = msgpack_restore(blob)
    except Exception:  # noqa: BLE001 — any decode failure means "not restorable"
        return False
    return isinstance(payload, dict) and not (_REQUIRED_KEYS - set(payload))


class CheckpointManager:
    """Read side of the JAX checkpoint directory: selection and loading."""

    def __init__(self, directory: str | Path) -> None:
        self._dir = Path(directory)

    def all_manifests(self) -> list[Path]:
        """Committed steps' payload paths, oldest first."""
        if not self._dir.is_dir():
            return []
        found = []
        for path in self._dir.iterdir():
            m = _MANIFEST_RE.match(path.name)
            if m:
                step = int(m.group(1))
                found.append((step, self._dir / f"step_{step:06d}.ckpt"))
        return [p for _, p in sorted(found)]

    def all_checkpoints(self) -> list[Path]:
        """Checkpoint payloads sorted by step, oldest first."""
        if not self._dir.is_dir():
            return []
        found = [
            (int(m.group(1)), path)
            for path in self._dir.iterdir()
            if (m := _STEP_RE.match(path.name))
        ]
        return [p for _, p in sorted(found)]

    def verify_manifest(self, ckpt: str | Path) -> bool:
        manifest = read_manifest(Path(ckpt))
        return manifest is not None and _manifest_files_ok(self._dir, manifest)

    def latest_valid_checkpoint(self) -> Path | None:
        """Newest committed checkpoint whose manifest verifies, scanning
        back past damaged steps (each skip warns); directories without
        manifests fall back to per-file verification; when nothing
        verifies, the plain newest (whose load then fails precisely)."""
        from ..utils.logging import get_logger

        for path in reversed(self.all_manifests()):
            if self.verify_manifest(path):
                return path
            get_logger().warning(
                "checkpoint %s failed integrity verification against its "
                "commit manifest; falling back to the previous one",
                path,
            )
        ckpts = self.all_checkpoints()
        for path in reversed(ckpts):
            if _verify_file(path):
                return path
            get_logger().warning(
                "checkpoint %s failed integrity verification; "
                "falling back to the previous one",
                path,
            )
        return ckpts[-1] if ckpts else None

    @staticmethod
    def load(path: str | Path) -> dict[str, Any]:
        """Read and validate a checkpoint payload, checking the sha-256
        sidecar first when one exists."""
        path = Path(path)
        if not path.is_file():
            raise CheckpointError(f"Checkpoint file not found: {path}")
        blob = path.read_bytes()
        expected = _read_sidecar_digest(path)
        if expected is not None:
            actual = hashlib.sha256(blob).hexdigest()
            if actual != expected:
                raise CheckpointError(
                    f"Checkpoint {path} failed sha-256 integrity verification "
                    f"(expected {expected[:12]}…, got {actual[:12]}…): the file "
                    "is truncated or corrupt"
                )
        try:
            payload = msgpack_restore(blob)
        except Exception as exc:
            raise CheckpointError(
                f"Checkpoint {path} is not a parseable msgpack payload "
                f"(truncated or corrupt): {exc}"
            ) from exc
        if not isinstance(payload, dict):
            raise CheckpointError(f"Checkpoint {path} does not hold a payload mapping")
        missing = _REQUIRED_KEYS - set(payload)
        if missing:
            raise CheckpointError(
                f"Checkpoint {path} is missing required keys: {sorted(missing)}"
            )
        return payload


def warn_on_config_mismatch(
    payload: dict[str, Any], current_config_yaml: str, path: str | Path
) -> None:
    """Warn and continue when the stored config differs from the current
    one (same text comparison as the JAX loader)."""
    if payload["config_yaml"] != current_config_yaml:
        from ..utils.logging import get_logger

        get_logger().warning(
            "checkpoint config differs from current config; "
            "continuing with the CURRENT config (checkpoint: %s)",
            path,
        )


def load_inference_params(
    path: str | Path,
    model: torch.nn.Module,
    *,
    expected_config_yaml: str | None = None,
) -> int:
    """Load a checkpoint's params (no optimizer state) into ``model``
    (strict: every parameter must be present) and return its step."""
    from ..interop.flax_params import flax_gpt_params_to_state_dict

    payload = CheckpointManager.load(path)
    if expected_config_yaml is not None:
        warn_on_config_mismatch(payload, expected_config_yaml, path)
    model.load_state_dict(flax_gpt_params_to_state_dict(payload["params"]), strict=True)
    return int(payload["step"])


def resolve_resume_path(resume_spec: str, output_root: str | Path) -> Path:
    """Resolve a ``--from`` spec (the JAX ``resolve_resume_path``).

    file → itself; dir → newest valid inside (falling back to its
    ``checkpoints/`` subdir); bare ``*.ckpt``/``*.pt`` string →
    FileNotFoundError; anything else → a run id under
    ``{output_root}/{run_id}/checkpoints``.
    """
    candidate = Path(resume_spec)
    if candidate.is_file():
        return candidate
    if candidate.is_dir():
        latest = CheckpointManager(candidate).latest_valid_checkpoint()
        if latest is None and (candidate / "checkpoints").is_dir():
            latest = CheckpointManager(candidate / "checkpoints").latest_valid_checkpoint()
        if latest is None:
            raise FileNotFoundError(f"No checkpoints found in directory: {candidate}")
        return latest
    if resume_spec.endswith((".ckpt", ".pt")):
        raise FileNotFoundError(f"Checkpoint file does not exist: {resume_spec}")
    run_ckpt_dir = Path(output_root) / resume_spec / "checkpoints"
    if not run_ckpt_dir.is_dir():
        raise FileNotFoundError(
            f"Resume spec {resume_spec!r} is neither a file, a directory, "
            f"nor a run id with checkpoints under {run_ckpt_dir}"
        )
    latest = CheckpointManager(run_ckpt_dir).latest_valid_checkpoint()
    if latest is None:
        raise FileNotFoundError(f"No checkpoints found for run id {resume_spec!r}")
    return latest


__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "load_inference_params",
    "manifest_path",
    "msgpack_restore",
    "read_manifest",
    "resolve_resume_path",
    "sidecar_path",
    "warn_on_config_mismatch",
]
