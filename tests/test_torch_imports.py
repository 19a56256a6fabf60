"""The port stands alone: no module of llmtrain_tpu_torch, and not
chip_smoke.py or the tools that run on the card beside it (tools/chip_*.py),
imports jax, flax, optax or the JAX package (the card's machine has no
JAX)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

_ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "llmtrain_tpu")
_FILES = (sorted((_ROOT / "llmtrain_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
          + sorted((_ROOT / "tools").glob("chip_*.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _FILES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_module_imports_no_jax(path: Path) -> None:
    assert not (_imported_roots(path) & set(_FORBIDDEN)), path


def test_walk_covers_the_package() -> None:
    names = {p.name for p in _FILES}
    assert {"gpt.py", "flash_attention.py", "http.py", "cli.py", "chip_smoke.py"} <= names
    assert {"fused_norm.py", "trainer.py", "train_step.py", "optimizer.py", "dry_run.py",
            "local_text.py", "sampler.py", "prefetch.py", "hw.py", "summary.py"} <= names
    assert {"fused_ce.py", "chunked_ce.py"} <= names
    assert {"engine.py", "scheduler.py", "paged_kv.py", "overload.py", "loadgen.py"} <= names
    assert {"exit_codes.py", "dummy_text.py", "mixed_text.py", "bpe.py", "dummy_gpt.py",
            "torch_interop.py"} <= names
    assert {"faults.py", "chip_smoke_ddp.py", "chip_smoke_offline.py"} <= names
    assert {"llama.py", "qwen2.py", "gemma.py", "moe.py", "gpt_moe.py", "lora.py",
            "llama_hf.py", "chip_smoke_zoo.py"} <= names
    assert _ROOT / "llmtrain_tpu_torch" / "distributed" / "__init__.py" in _FILES
    native = _ROOT / "llmtrain_tpu_torch" / "native" / "__init__.py"
    assert native in _FILES and (native.parent / "fastbpe.c").is_file()


def test_kernel_modules_import_triton_only_inside_functions() -> None:
    """This machine has no Triton: the kernel modules import it lazily."""
    for name in ("fused_norm.py", "flash_attention.py", "fused_ce.py", "chunked_ce.py"):
        path = _ROOT / "llmtrain_tpu_torch" / "ops" / name
        tree = ast.parse(path.read_text(encoding="utf-8"))
        top = {alias.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
               for alias in node.names}
        top |= {node.module.split(".")[0] for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.module}
        assert "triton" not in top, name


def test_forbidden_import_is_detected(tmp_path: Path) -> None:
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom llmtrain_tpu.ops import rope\n")
    assert "llmtrain_tpu" in _imported_roots(bad)
