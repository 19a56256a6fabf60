"""Native (C) host helpers, built on demand with a pure-Python fallback
(port of ``llmtrain_tpu/native/__init__.py``; the port keeps its own copy
of the loader and of ``fastbpe.c``).

``fastbpe`` speeds up the BPE tokenizer's cold-word merge loop
(data/bpe.py), the dominant cost of tokenizing source code, where the
per-word memo rarely hits. The shared object is compiled once per source
hash with the host C compiler into ``build/native/`` at the checkout root
(git ignores ``build/``, as it does the CUDA kernels' ``build/kernels/``)
and loaded with ctypes. Any failure (no compiler, read-only checkout)
means the pure-Python encoder, which gives the same ids: nothing here is
load-bearing for correctness. It is a host helper, not a device kernel.

Set ``LLMTRAIN_NO_NATIVE=1`` to force the Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC = Path(__file__).with_name("fastbpe.c")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib: ctypes.CDLL | None = None
_lib_tried = False


def _compiler() -> str | None:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def _build() -> Path | None:
    # Everything inside the try: any failure (missing source, read-only
    # build dir, broken compiler) means "no native encoder", never an
    # exception.
    tmp: Path | None = None
    try:
        src = _SRC.read_bytes()
        out = BUILD_DIR / f"fastbpe-{hashlib.sha256(src).hexdigest()[:16]}.so"
        if out.exists():
            return out
        cc = _compiler()
        if cc is None:
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        # Per-process tmp: concurrent builders (pytest-xdist workers) must
        # not interleave writes into one file and promote a corrupt .so.
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        tmp.replace(out)
        return out
    except Exception:  # noqa: BLE001 — the fallback is the contract
        if tmp is not None:
            tmp.unlink(missing_ok=True)
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if os.environ.get("LLMTRAIN_NO_NATIVE") == "1":
        return None
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.fastbpe_new.restype = ctypes.c_void_p
        lib.fastbpe_new.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.fastbpe_free.argtypes = [ctypes.c_void_p]
        lib.fastbpe_encode_word.restype = ctypes.c_int32
        lib.fastbpe_encode_word.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    except OSError:
        return None
    _lib = lib
    return _lib


class FastBpeEncoder:
    """ctypes wrapper over one vocabulary's native merge table."""

    def __init__(self, lib: ctypes.CDLL, merges: list[tuple[int, int]]) -> None:
        flat = (ctypes.c_int32 * (2 * len(merges)))()
        for i, (a, b) in enumerate(merges):
            flat[2 * i] = a
            flat[2 * i + 1] = b
        self._lib = lib
        self._ctx = lib.fastbpe_new(flat, len(merges))
        if not self._ctx:
            raise MemoryError("fastbpe_new failed")

    def encode_word(self, word: str) -> list[int]:
        raw = word.encode("utf-8")
        n = len(raw)
        if n == 0:
            return []
        buf_in = (ctypes.c_uint8 * n).from_buffer_copy(raw)
        buf_out = (ctypes.c_int32 * n)()
        count = self._lib.fastbpe_encode_word(self._ctx, buf_in, n, buf_out)
        return list(buf_out[:count])

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib = getattr(self, "_lib", None)
        ctx = getattr(self, "_ctx", None)
        if lib is not None and ctx:
            lib.fastbpe_free(ctx)


def fastbpe_encoder(merges: list[tuple[int, int]]) -> FastBpeEncoder | None:
    """A native encoder for this merge list, or None (the Python path)."""
    lib = _load()
    if lib is None:
        return None
    try:
        return FastBpeEncoder(lib, merges)
    except MemoryError:
        return None


__all__ = ["FastBpeEncoder", "fastbpe_encoder"]
