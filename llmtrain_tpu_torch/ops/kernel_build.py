"""Build the hand-written CUDA kernels on first use and load them with ctypes.

Each ``csrc/*.cu`` file is a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into a shared library under
``build/kernels/`` at the checkout root. The library's file name carries
a hash of the source, the shared headers beside it (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged one
loads the existing library.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    """One source's build: the library path, the compiler's resource
    report (``-Xptxas -v``), and the seconds ``nvcc`` took (0.0 when an
    up-to-date library was reused)."""

    source: Path
    library: Path
    ptxas_report: str
    seconds: float


def find_nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``,
    then the toolkit's default install prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels are built from csrc/ on first use"
    )


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def _start_build(source: Path) -> tuple[Path, subprocess.Popen | None, Path, float]:
    """Start ``nvcc`` for ``source`` unless an up-to-date library exists:
    (library, process or None, temporary output, start time)."""
    lib = _library_path(source)
    if lib.is_file():
        return lib, None, lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return lib, proc, tmp, time.perf_counter()


def _finish_build(source: Path, started: tuple) -> BuildResult:
    lib, proc, tmp, t0 = started
    report = lib.with_suffix(".ptxas.txt")
    if proc is None:
        return BuildResult(source, lib, report.read_text() if report.is_file() else "", 0.0)
    output, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name}:\n{output}")
    tmp.replace(lib)
    report.write_text(output)
    return BuildResult(source, lib, output, seconds)


def build_libraries(sources: list[Path]) -> list[BuildResult]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together; each result's ``seconds`` runs from
    its start until its output is collected, in source order. Raises with
    the compiler's output when a build fails (after every started build
    has ended)."""
    started = [(source, _start_build(source)) for source in sources]
    results, failures = [], []
    for source, handle in started:
        try:
            results.append(_finish_build(source, handle))
        except RuntimeError as exc:
            failures.append(str(exc))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def build_library(source: Path) -> BuildResult:
    """Compile ``source`` unless an up-to-date library exists, and return
    its :class:`BuildResult`."""
    return build_libraries([source])[0]


def load_library(source_name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source_name>``, building it
    first if no up-to-date build exists."""
    with _LOCK:
        lib = _LOADED.get(source_name)
        if lib is None:
            result = build_library(CSRC_DIR / source_name)
            lib = ctypes.CDLL(str(result.library))
            _LOADED[source_name] = lib
        return lib


__all__ = [
    "BUILD_DIR",
    "BuildResult",
    "CSRC_DIR",
    "build_libraries",
    "build_library",
    "find_nvcc",
    "load_library",
]
