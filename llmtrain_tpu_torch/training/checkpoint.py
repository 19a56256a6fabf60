"""Checkpoints (port of ``llmtrain_tpu/training/checkpoint.py``).

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
  model through the weight carry-over of its family (the GPT or
  ``dummy_gpt``, interop/flax_params.py).

Write side: :meth:`CheckpointManager.save_host` stages the payload and
its sidecar (tmp write, fsync, rename), then publishes the manifest by
atomic rename (the commit point), tells the ``on_commit`` observer, then
prunes to the last k steps (never the newest verified one), sweeping dead
stages and adopting complete unmanifested payloads as JAX does.
:meth:`CheckpointManager.save_host_async` runs it on a daemon thread, one
write in flight, as JAX's does: the caller has already gathered an owned
host copy of the state (the trainer's ``host_state``), so msgpack,
sha-256, fsync and the publish overlap the next steps; ``poll``,
``wait_pending(timeout)`` and ``close(timeout)`` surface its failure, and
bound the drain on abort paths. :func:`msgpack_serialize` writes
flax's msgpack layout without flax, and the params go back to flax names
and shapes (interop/flax_params.py), so the JAX package's
``CheckpointManager.load`` and ``load_inference_params`` read what the
port writes. ``opt_state`` carries the port's own layout
(training/optimizer.py), except the EMA shadow, which is stored as JAX
stores it: the param tree in flax names and shapes under
``__param_ema__`` (:func:`opt_state_to_host`), so either package's
``--ema`` reads the other's shadow (:func:`ema_from_payload`). Selection
(:meth:`CheckpointManager.latest_valid_checkpoint`, ``before_step`` for the
spike rollback's restore point) is JAX's, adoption of a manifest-less
payload included.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from pathlib import Path
from typing import Any, Callable

import msgpack
import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{6,})\.ckpt$")
_MANIFEST_RE = re.compile(r"^step_(\d{6,})\.manifest\.json$")
_REQUIRED_KEYS = {"checkpoint_version", "step", "params", "opt_state", "config_yaml"}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
CHECKPOINT_VERSION = 1
MANIFEST_VERSION = 1
MAX_CHUNK_SIZE = 2**30  # flax splits array leaves above this many bytes


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


def _array_bytes(shape: tuple[int, ...], dtype_name: str, buffer: bytes) -> bytes:
    return msgpack.packb((tuple(shape), dtype_name, buffer), use_bin_type=True)


def _ext_pack(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            buffer = t.view(torch.int16).numpy().tobytes()
            return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(t.shape, "bfloat16", buffer))
        return _ext_pack(t.numpy())
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(
            _EXT_NDARRAY, _array_bytes(x.shape, x.dtype.name, x.tobytes("C"))
        )
    if isinstance(x, np.generic):
        arr = np.asarray(x)
        return msgpack.ExtType(
            _EXT_NPSCALAR, _array_bytes(arr.shape, arr.dtype.name, arr.tobytes("C"))
        )
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _chunk_large(tree: Any) -> Any:
    """flax's chunking of array leaves above MAX_CHUNK_SIZE bytes, with
    dict keys in sorted order as flax's tree copy leaves them."""
    if isinstance(tree, dict):
        return {k: _chunk_large(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor) and tree.dtype != torch.bfloat16:
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
        return {
            "__msgpack_chunked_array__": True,
            "shape": {str(i): n for i, n in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)},
        }
    return tree


def msgpack_serialize(pytree: Any) -> bytes:
    """Encode nested dicts of arrays (numpy, or torch tensors including
    bfloat16) and Python scalars as ``flax.serialization.msgpack_serialize``
    does, so flax's ``msgpack_restore`` reads them back."""
    return msgpack.packb(_chunk_large(pytree), default=_ext_pack, strict_types=True)


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


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    """Durably record renames in the directory itself (best effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _file_entry(path: Path) -> tuple[str, int, str]:
    """(name, size, sha256) manifest entry for an existing file."""
    blob = path.read_bytes()
    return (path.name, len(blob), hashlib.sha256(blob).hexdigest())


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
    """A checkpoint directory in the JAX layout: save (synchronously or on
    a writer thread) with the atomic commit protocol, prune, select and
    load."""

    def __init__(
        self,
        directory: str | Path,
        *,
        keep_last_k: int = 3,
        on_commit: Callable[[int, Path], None] | None = None,
    ) -> None:
        self._dir = Path(directory)
        self._keep_last_k = max(1, keep_last_k)
        self._pending: Future | None = None  # the in-flight async write
        self._writer: Any = None  # its thread
        # Commit observer: called (step, manifest_path) right after the
        # manifest rename lands — from the WRITER thread on async saves, so
        # consumers must be thread-safe (the telemetry registry is).
        self.on_commit = on_commit
        # Verification results keyed by (path, size, mtime_ns): pruning and
        # rollback re-verify the same unchanged files every save.
        self._verify_cache: dict[tuple[str, int, int], bool] = {}

    @property
    def directory(self) -> Path:
        return self._dir

    def save_host(
        self,
        step: int,
        host_state: dict[str, Any],
        resolved_config: dict[str, Any],
        *,
        resilience: dict[str, Any] | None = None,
        manifest_extra: dict[str, Any] | None = None,
        inject_kill: bool = False,
    ) -> Path:
        """Stage and atomically commit one step: payload, then sidecar
        (each tmp write → fsync → rename), then the manifest publish, which
        is the commit point; then the ``on_commit`` observer, then prune.
        ``host_state`` holds ``params`` (flax tree) and ``opt_state``.
        ``inject_kill`` (``faults.kill_during_checkpoint``) SIGKILLs the
        process between the staged files and the manifest publish."""
        import yaml

        self._dir.mkdir(parents=True, exist_ok=True)
        payload = {
            "checkpoint_version": CHECKPOINT_VERSION,
            "step": np.int64(step),
            "params": host_state["params"],
            "opt_state": host_state["opt_state"],
            "config_yaml": yaml.safe_dump(resolved_config, sort_keys=False),
        }
        if resilience:
            payload["resilience"] = {k: np.asarray(v) for k, v in resilience.items()}
        target = self._dir / f"step_{step:06d}.ckpt"
        blob = msgpack_serialize(payload)
        digest = hashlib.sha256(blob).hexdigest()
        # Re-saving a step (rollback replay): withdraw the old one, payload
        # first, so a crash mid-rewrite leaves the step unselectable rather
        # than mixed.
        target.unlink(missing_ok=True)
        sidecar_path(target).unlink(missing_ok=True)
        manifest_path(target).unlink(missing_ok=True)
        tmp = target.with_suffix(".ckpt.tmp")
        tmp.write_bytes(blob)
        _fsync_file(tmp)
        tmp.replace(target)
        side = sidecar_path(target)
        side_tmp = side.with_name(side.name + ".tmp")
        side_tmp.write_text(f"{digest}  {target.name}\n", encoding="utf-8")
        _fsync_file(side_tmp)
        side_tmp.replace(side)
        if inject_kill:
            import signal

            from ..utils.logging import get_logger

            get_logger().warning(
                "fault injection: SIGKILL inside the checkpoint write at "
                "step %d (staged files present, manifest NOT published)",
                step,
            )
            os.kill(os.getpid(), signal.SIGKILL)
        self._publish_manifest(
            target, [(target.name, len(blob), digest), _file_entry(side)], manifest_extra
        )
        stat = target.stat()
        self._verify_cache[(str(target), stat.st_size, stat.st_mtime_ns)] = True
        self._verify_cache[(str(manifest_path(target)), stat.st_size, stat.st_mtime_ns)] = True
        if self.on_commit is not None:
            try:
                self.on_commit(step, manifest_path(target))
            except Exception:  # noqa: BLE001 — the observer must not fail the save
                pass
        self._prune()
        return target

    def save_host_async(
        self,
        step: int,
        host_state: dict[str, Any],
        resolved_config: dict[str, Any],
        *,
        resilience: dict[str, Any] | None = None,
        manifest_extra: dict[str, Any] | None = None,
        inject_kill: bool = False,
    ) -> None:
        """Queue :meth:`save_host` on a background thread, one write in
        flight: queueing first drains (and re-raises the error of) the
        previous one. ``host_state`` must be owned by the caller and never
        mutated afterwards (the trainer's ``host_state`` copies every
        tensor off the device). A plain daemon thread + Future, not a
        ThreadPoolExecutor, whose non-daemon workers are joined at exit: a
        write wedged on dead storage must not hold the process after
        ``close(timeout)`` abandoned it."""
        import threading

        self.wait_pending()
        future: Future = Future()

        def work() -> None:
            # False: wait_pending cancelled the write before it started.
            if not future.set_running_or_notify_cancel():
                return
            try:
                future.set_result(self.save_host(
                    step, host_state, resolved_config, resilience=resilience,
                    manifest_extra=manifest_extra, inject_kill=inject_kill,
                ))
            except BaseException as exc:  # noqa: BLE001 — delivered via result()
                future.set_exception(exc)

        writer = threading.Thread(target=work, name="ckpt-write", daemon=True)
        writer.start()
        self._pending = future
        self._writer = writer

    def poll(self) -> None:
        """Non-blocking failure check: re-raise the error of an async write
        that has already finished with one (the trainer calls it at each
        log boundary, so a failed write fails the run within an interval)."""
        pending = self._pending
        if pending is not None and pending.done():
            self._pending = None
            pending.result()

    def wait_pending(self, timeout: float | None = None) -> bool:
        """Block until the in-flight async write (if any) finishes and
        re-raise its error. With a ``timeout``, give up after that many
        seconds and return False, leaving the write in flight (a queued
        write that has not started is withdrawn, with an error log).
        Returns True when nothing is (any longer) pending."""
        pending = self._pending
        if pending is None:
            return True
        if timeout is not None and not pending.done() and pending.cancel():
            from ..utils.logging import get_logger

            get_logger().error(
                "queued async checkpoint write cancelled before it started "
                "(bounded drain); the newest on-disk checkpoint may be one "
                "save behind"
            )
            self._pending = None
            return True
        self._pending = None
        try:
            pending.result(timeout)
        except FuturesTimeoutError:
            # Still running: keep it, so a later drain can see its outcome.
            self._pending = pending
            return False
        finally:
            if pending.done() and self._writer is not None:
                # The writer returns right after delivering its result: let
                # it finish, so no thread of it outlives a drained manager.
                self._writer.join()
                self._writer = None
        return True

    def close(self, timeout: float | None = None) -> None:
        """Drain the pending write. A ``timeout`` bounds the drain: on
        expiry the write is ABANDONED (logged as an error; the daemon
        writer thread cannot block process exit)."""
        try:
            if not self.wait_pending(timeout):
                from ..utils.logging import get_logger

                get_logger().error(
                    "async checkpoint write still in flight after %.1fs; "
                    "abandoning it (the newest on-disk checkpoint may be one "
                    "save behind)",
                    timeout,
                )
        finally:
            self._pending = None

    def _publish_manifest(
        self,
        target: Path,
        files: list[tuple[str, int, str]],
        manifest_extra: dict[str, Any] | None,
        *,
        synthesized: bool = False,
    ) -> Path:
        """Atomic-rename publish of the commit record for ``target``."""
        step = int(_STEP_RE.match(target.name).group(1))
        manifest: dict[str, Any] = {
            "manifest_version": MANIFEST_VERSION,
            "step": step,
            "files": [{"name": n, "bytes": size, "sha256": d} for n, size, d in files],
        }
        if synthesized:
            manifest["synthesized"] = True
        if manifest_extra:
            manifest.update(manifest_extra)
        mpath = manifest_path(target)
        mtmp = mpath.with_name(mpath.name + ".tmp")
        mtmp.write_text(json.dumps(manifest, indent=1, sort_keys=False), encoding="utf-8")
        _fsync_file(mtmp)
        mtmp.replace(mpath)
        _fsync_dir(self._dir)
        return mpath

    def _prune(self) -> None:
        """Keep the last k checkpoints by step, but never delete the newest
        verified one; sweep dead commit stages first."""
        self._collect_orphans()
        ckpts = self.all_checkpoints()
        doomed = ckpts[: -self._keep_last_k]
        if not doomed:
            return
        newest_valid = next((p for p in reversed(ckpts) if self.verify(p)), None)
        for path in doomed:
            if path == newest_valid:
                continue
            path.unlink(missing_ok=True)
            sidecar_path(path).unlink(missing_ok=True)
            manifest_path(path).unlink(missing_ok=True)

    def _collect_orphans(self) -> None:
        """Delete leftover ``*.tmp`` stages and manifests whose payload is
        gone; adopt an unmanifested payload that verifies (synthesized
        manifest), delete one that does not."""
        if not self._dir.is_dir():
            return
        from ..utils.logging import get_logger

        manifested = {
            int(m.group(1)) for p in self._dir.iterdir() if (m := _MANIFEST_RE.match(p.name))
        }
        if not manifested:
            return
        for path in list(self._dir.iterdir()):
            if path.name.endswith(".tmp"):
                path.unlink(missing_ok=True)
                continue
            mm = _MANIFEST_RE.match(path.name)
            if mm and not (self._dir / f"step_{int(mm.group(1)):06d}.ckpt").is_file():
                path.unlink(missing_ok=True)
                continue
            m = _STEP_RE.match(path.name)
            if not m or int(m.group(1)) in manifested:
                continue
            if self.verify(path):
                try:
                    self.synthesize_manifest(path)
                    get_logger().warning(
                        "adopted unmanifested checkpoint %s (complete payload whose "
                        "commit was interrupted): synthesized its manifest",
                        path.name,
                    )
                except OSError:
                    pass
            else:
                get_logger().warning(
                    "garbage-collecting torn uncommitted checkpoint stage %s", path.name
                )
                path.unlink(missing_ok=True)
                sidecar_path(path).unlink(missing_ok=True)

    def synthesize_manifest(self, ckpt: str | Path) -> Path:
        """Write a commit manifest for an existing payload (adoption)."""
        ckpt = Path(ckpt)
        files = [_file_entry(ckpt)]
        if sidecar_path(ckpt).is_file():
            files.append(_file_entry(sidecar_path(ckpt)))
        return self._publish_manifest(ckpt, files, None, synthesized=True)

    def latest_checkpoint(self) -> Path | None:
        """The newest payload by step, verified or not."""
        ckpts = self.all_checkpoints()
        return ckpts[-1] if ckpts else None

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

    def verify(self, path: str | Path) -> bool:
        """True when ``path`` is a restorable checkpoint: its sha-256
        sidecar digest matches, or without a sidecar it deep-parses.
        Cached by (path, size, mtime_ns)."""
        path = Path(path)
        try:
            stat = path.stat()
        except OSError:
            return False
        key = (str(path), stat.st_size, stat.st_mtime_ns)
        cached = self._verify_cache.get(key)
        if cached is None:
            cached = self._verify_cache[key] = _verify_file(path)
        return cached

    def verify_manifest(self, ckpt: str | Path) -> bool:
        """True when ``ckpt``'s commit manifest exists and every listed
        file is present with its recorded size and digest. Cached by the
        payload's (size, mtime_ns) under the manifest's path."""
        ckpt = Path(ckpt)
        manifest = read_manifest(ckpt)
        if manifest is None:
            return False
        try:
            stat = ckpt.stat()
        except OSError:
            return False
        key = (str(manifest_path(ckpt)), stat.st_size, stat.st_mtime_ns)
        cached = self._verify_cache.get(key)
        if cached is None:
            cached = self._verify_cache[key] = _manifest_files_ok(self._dir, manifest)
        return cached

    def latest_valid_checkpoint(self, *, before_step: int | None = None) -> Path | None:
        """Newest committed checkpoint whose manifest verifies, scanning
        back past damaged steps (each skip warns); directories without
        manifests fall back to per-file verification, and the payload
        picked there gets a manifest synthesized in place (JAX's
        migration); when nothing verifies, the plain newest (whose load
        then fails precisely).
        ``before_step`` (the spike rollback) only considers steps saved
        strictly before it, and then None means nothing is restorable."""
        from ..utils.logging import get_logger

        def step_of(p: Path) -> int:
            return int(_STEP_RE.match(p.name).group(1))

        manifests = self.all_manifests()
        candidates = manifests
        if before_step is not None:
            candidates = [p for p in manifests if step_of(p) < before_step]
        for path in reversed(candidates):
            if self.verify_manifest(path):
                return path
            get_logger().warning(
                "checkpoint %s failed integrity verification against its "
                "commit manifest; falling back to the previous one",
                path,
            )
        if manifests and before_step is not None:
            return None
        # Every committed step is damaged (or none exists): the per-file scan.
        ckpts = self.all_checkpoints()
        if before_step is not None:
            ckpts = [p for p in ckpts if step_of(p) < before_step]
        for path in reversed(ckpts):
            if self.verify(path):
                if read_manifest(path) is None:
                    # Adopt the pre-manifest (or interrupted-commit) payload,
                    # as JAX does, so later scans see a committed step;
                    # best-effort: a read-only directory still resolves.
                    try:
                        self.synthesize_manifest(path)
                    except OSError:
                        pass
                return path
            get_logger().warning(
                "checkpoint %s failed integrity verification; "
                "falling back to the previous one",
                path,
            )
        if before_step is not None:
            return None
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
    from ..interop.flax_params import flax_params_to_state_dict

    payload = CheckpointManager.load(path)
    if expected_config_yaml is not None:
        warn_on_config_mismatch(payload, expected_config_yaml, path)
    tree = _tree_for(payload["params"], model)
    model.load_state_dict(flax_params_to_state_dict(tree), strict=True)
    return int(payload["step"])


def _tree_for(tree: Any, model: torch.nn.Module) -> Any:
    """A stored param tree in ``model``'s layout: a ``gpt_pipeline`` tree
    loads into the plain GPT its decode paths run (interop/pipeline_convert.py)."""
    from ..interop.pipeline_convert import is_pipeline_tree, pipeline_params_to_gpt

    if is_pipeline_tree(tree) and not getattr(model, "stacks_layers", False):
        return pipeline_params_to_gpt(tree)
    return tree


def opt_state_to_host(opt_state: dict[str, Any], *, n_heads: int,
                      n_kv_heads: int | None = None, lora: bool = False) -> dict[str, Any]:
    """An optimizer's ``state_dict`` as a checkpoint stores it: the EMA
    shadow (keyed by the port's parameter names) goes to the JAX param
    layout; with ``lora`` (the run's params are a LoRA tree,
    :func:`~llmtrain_tpu_torch.interop.flax_params.is_lora_tree`) to the
    factor subtree, as JAX's masked optimizer keeps it. Everything else
    stays the port's."""
    from ..interop.flax_params import state_dict_to_flax_params, state_dict_to_lora_tree
    from .optimizer import EMA_STATE_KEY

    ema = opt_state.get(EMA_STATE_KEY)
    if ema is None:
        return opt_state
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in ema.items()}
    if lora:
        return {**opt_state, EMA_STATE_KEY: state_dict_to_lora_tree(sd)}
    tree = state_dict_to_flax_params(sd, n_heads=n_heads, n_kv_heads=n_kv_heads)
    return {**opt_state, EMA_STATE_KEY: tree}


def opt_state_from_host(opt_state: dict[str, Any], *, lora: bool = False) -> dict[str, Any]:
    """The inverse of :func:`opt_state_to_host`: the stored shadow back to
    the port's parameter names (f32)."""
    from .optimizer import EMA_STATE_KEY

    ema = opt_state.get(EMA_STATE_KEY) if isinstance(opt_state, dict) else None
    if ema is None:
        return opt_state
    return {**opt_state, EMA_STATE_KEY: _shadow_state_dict(ema, lora)}


def _shadow_state_dict(tree: Any, lora: bool) -> dict[str, torch.Tensor]:
    """A stored EMA shadow as the port's parameter names: a family tree,
    or with ``lora`` a LoRA run's factor subtree (``lora.*``)."""
    from ..interop.flax_params import flax_params_to_state_dict, lora_tree_to_state_dict

    return lora_tree_to_state_dict(tree) if lora else flax_params_to_state_dict(tree)


def ema_from_payload(payload: dict[str, Any], model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The EMA shadow of a loaded checkpoint payload (either package's) as
    ``model``'s ``state_dict``, each tensor cast back to the dtype of the
    parameter it shadows. Raises ``ValueError`` (JAX's text) when the
    payload holds no EMA state."""
    from ..interop.flax_params import flax_params_to_state_dict, is_lora_tree
    from .optimizer import find_ema_tree

    raw = find_ema_tree(payload["opt_state"])
    if raw is None:
        raise ValueError(
            "checkpoint holds no EMA state — train with "
            "trainer.extra.ema_decay to track shadow weights"
        )
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    lora = is_lora_tree(payload["params"])
    shadow = _shadow_state_dict(raw if lora else _tree_for(raw, model), lora)
    if lora:
        # A LoRA run's shadow covers the factors; the frozen base loads as
        # stored (JAX's ``_load_checkpoint_params``).
        base = flax_params_to_state_dict(payload["params"])
        shadow = {**{k: v for k, v in base.items() if k.startswith("base.")}, **shadow}
    return {k: v.to(dtypes.get(k, v.dtype)) for k, v in shadow.items()}


def load_ema_params(
    path: str | Path,
    model: torch.nn.Module,
    *,
    expected_config_yaml: str | None = None,
) -> int:
    """Load a checkpoint's EMA shadow (``trainer.extra.ema_decay``) into
    ``model`` as its weights and return the checkpoint's step."""
    payload = CheckpointManager.load(path)
    if expected_config_yaml is not None:
        warn_on_config_mismatch(payload, expected_config_yaml, path)
    model.load_state_dict(ema_from_payload(payload, model), strict=True)
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
    "ema_from_payload",
    "load_ema_params",
    "load_inference_params",
    "manifest_path",
    "msgpack_restore",
    "msgpack_serialize",
    "opt_state_from_host",
    "opt_state_to_host",
    "read_manifest",
    "resolve_resume_path",
    "sidecar_path",
    "warn_on_config_mismatch",
]
