"""Typo detection in the ``extra`` sections (config/extras.py) and
``trainer.extra.step_delay_sec``, the port against the JAX package, on
the CPU.

* ``unknown_extra_keys`` equals JAX's on every preset of
  ``configs/presets/`` and on typos in ``model.extra``, ``data.extra`` and
  ``trainer.extra`` (each alone and all three together).
* Both CLIs' ``validate`` print the same warning lines, one per section.
* ``step_delay_sec`` is a known trainer key that sleeps after each step
  and changes nothing of the math.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import pytest
import yaml
from torch_port_helpers import REPO_ROOT, run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.config.extras import TRAINER_EXTRA_KEYS as JAX_TRAINER_KEYS
from llmtrain_tpu.config.extras import unknown_extra_keys as jax_unknown
from llmtrain_tpu.config.schemas import RunConfig as JaxRunConfig
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.config.extras import TRAINER_EXTRA_KEYS, unknown_extra_keys
from llmtrain_tpu_torch.config.schemas import RunConfig

PRESETS = sorted(p.stem for p in (REPO_ROOT / "configs" / "presets").glob("*.yaml"))


def _preset(name: str) -> dict:
    return yaml.safe_load((REPO_ROOT / "configs" / "presets" / f"{name}.yaml").read_text())


def _both(raw: dict) -> tuple[dict, dict]:
    from llmtrain_tpu.registry import initialize_registries

    initialize_registries()
    return (unknown_extra_keys(RunConfig.model_validate(raw)),
            jax_unknown(JaxRunConfig.model_validate(raw)))


def test_trainer_keys_are_jax_s() -> None:
    assert TRAINER_EXTRA_KEYS == JAX_TRAINER_KEYS and "step_delay_sec" in TRAINER_EXTRA_KEYS


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name: str) -> None:
    port, jax_out = _both(_preset(name))
    assert port == jax_out


TYPOS = {
    "model": {"model": {"extra": {"los_impl": "dense"}}},
    "data": {"data": {"extra": {"globz": ["*.py"]}}},
    "trainer": {"trainer": {"extra": {"ema_decya": 0.99}}},
    "all": {"model": {"extra": {"los_impl": "dense"}}, "data": {"extra": {"globz": ["*.py"]}},
            "trainer": {"extra": {"ema_decya": 0.99, "step_delay_sec": 0.0}}},
}


def _with_typos(base: str, typos: dict) -> dict:
    raw = _preset(base)
    for section, value in typos.items():
        raw.setdefault(section, {}).setdefault("extra", {}).update(value["extra"])
    return raw


@pytest.mark.parametrize("base", ["gpt_smoke", "gpt_pycorpus_tpu", "llama_smoke"])
@pytest.mark.parametrize("where", list(TYPOS))
def test_typos_match_jax(base: str, where: str) -> None:
    port, jax_out = _both(_with_typos(base, TYPOS[where]))
    assert port == jax_out and port
    sections = {"model.extra", "data.extra", "trainer.extra"} if where == "all" else {
        f"{where}.extra"}
    assert set(port) == sections


def test_validate_prints_jax_s_warning_lines(tmp_path, capsys) -> None:
    cfg = tmp_path / "typos.yaml"
    cfg.write_text(yaml.safe_dump(_with_typos("gpt_smoke", TYPOS["all"]), sort_keys=False))
    lines = []
    for main in (jax_main, port_main):
        assert run_cli(main, ["validate", "--config", str(cfg)]) == 0
        err = capsys.readouterr().err
        lines.append([x for x in err.splitlines() if x.startswith("warning:")])
    assert lines[0] == lines[1] and len(lines[1]) == 3
    assert lines[1][2] == ("warning: trainer.extra keys not recognized by 'trainer': "
                           "ema_decya (typo? they will be ignored)")


def _fit(tmp: Path, delay: float) -> tuple[float, float]:
    from llmtrain_tpu_torch.training.trainer import Trainer

    raw = _preset("gpt_smoke")
    raw["trainer"].update(max_steps=3, warmup_steps=0, log_every_steps=1)
    raw["trainer"].setdefault("extra", {})["step_delay_sec"] = delay
    raw["telemetry"] = {"enabled": False}
    t0 = time.perf_counter()
    result = Trainer(RunConfig.model_validate(raw), None).fit()
    return result.final_loss, time.perf_counter() - t0


def test_step_delay_sec_sleeps_without_touching_the_math(tmp_path) -> None:
    loss, _ = _fit(tmp_path, 0.0)
    delayed, wall = _fit(tmp_path, 0.4)
    assert math.isfinite(loss) and delayed == loss
    assert wall >= 3 * 0.4
