"""The port's config loader against the JAX loader, preset by preset."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch
import yaml

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.config import ConfigLoadError as JaxConfigLoadError
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu_torch import cli
from llmtrain_tpu_torch.config import ConfigLoadError, load_and_validate_config
from llmtrain_tpu_torch.distributed import resolve_device

_PRESETS = sorted((Path(__file__).resolve().parents[1] / "configs" / "presets").glob("*.yaml"))


@pytest.mark.parametrize("preset", _PRESETS, ids=lambda p: p.stem)
def test_preset_loads_to_the_same_values(preset: Path) -> None:
    ours, our_raw, our_resolved = load_and_validate_config(preset)
    theirs, their_raw, their_resolved = jax_load(preset)
    assert our_raw == their_raw == yaml.safe_load(preset.read_text())
    assert our_resolved == their_resolved
    # The checkpoint mismatch check compares this exact text.
    assert yaml.safe_dump(our_resolved, sort_keys=False) == yaml.safe_dump(
        their_resolved, sort_keys=False
    )


def test_presets_found() -> None:
    assert len(_PRESETS) >= 30


def _write(tmp_path: Path, device: str) -> Path:
    path = tmp_path / "c.yaml"
    path.write_text(
        f"run: {{name: t, device: {device}}}\n"
        "model: {name: gpt, vocab_size: 17}\n"
        "data: {name: dummy_text}\n"
        "trainer: {max_steps: 1, warmup_steps: 0}\n"
    )
    return path


def test_cuda_device_is_the_ports_only_schema_difference(tmp_path: Path) -> None:
    path = _write(tmp_path, "cuda")
    cfg, _, _ = load_and_validate_config(path)
    assert cfg.run.device == "cuda"
    with pytest.raises(JaxConfigLoadError):
        jax_load(path)


def test_validation_errors_are_structured(tmp_path: Path) -> None:
    path = _write(tmp_path, "mps")
    with pytest.raises(ConfigLoadError) as exc:
        load_and_validate_config(path)
    assert exc.value.errors and exc.value.errors[0]["loc"] == "run.device"


@pytest.mark.parametrize("device", ["tpu", "cuda", "cpu"])
def test_device_resolution_never_falls_back_to_the_cpu(device: str) -> None:
    if device == "cpu":
        assert resolve_device(device) == torch.device("cpu")
    elif torch.cuda.is_available():
        assert resolve_device(device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(device)


@pytest.mark.parametrize("command", ["generate", "serve"])
def test_config_without_device_runs_on_the_card_or_refuses(
    tmp_path: Path, monkeypatch: pytest.MonkeyPatch, command: str
) -> None:
    path = tmp_path / "c.yaml"
    path.write_text(_write(tmp_path, "cpu").read_text().replace(", device: cpu", ""))
    cfg, _, _ = load_and_validate_config(path)
    assert cfg.run.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(cfg.run.device)

    def _no_model_on_the_cpu(*args, **kwargs):
        raise AssertionError("the entry point went on without the card")

    monkeypatch.setattr(cli, "_build_decode_stack", _no_model_on_the_cpu)
    argv = [command, "--config", str(path), "--from", str(tmp_path)]
    if command == "generate":
        argv += ["--prompt-ids", "1,2"]
    assert cli.main(argv) == cli.EXIT_FAILURE
