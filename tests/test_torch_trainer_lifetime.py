"""A finished ``Trainer`` is freed with its last reference (ROADMAP C6).

``fit`` with a run dir ends with the cost count of a step on ``meta``
tensors (telemetry/profiling.py), whose first dynamo-disabled call makes
torch import ``torch._dynamo``; that import keeps the importing stack in
a reference cycle. Imported under ``fit``, it kept the trainer, its model
and its optimizer state on the device until the cycle collector ran.

The check runs in a fresh interpreter (in this process the import is
long done): with the collector disabled, a trainer of each family is fit
with a run dir and dropped, and weak references to it and to its model
must be dead.
"""

from __future__ import annotations

import json
import subprocess
import sys

from torch_port_helpers import port_env

_CHILD = r"""
import gc, json, sys, tempfile, weakref
from pathlib import Path

import yaml

from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.training.trainer import Trainer

results = {}
root = Path(tempfile.mkdtemp())
for name in ("gpt", "llama"):
    raw = {
        "run": {"name": name, "seed": 1, "device": "cpu"},
        "model": {"name": name, "block_size": 16, "d_model": 32, "n_layers": 2,
                  "n_heads": 2, "d_ff": 64, "vocab_size": 40, "dropout": 0.0},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 3, "micro_batch_size": 2, "warmup_steps": 0,
                    "log_every_steps": 1, "eval_every_steps": 3, "save_every_steps": 3},
        "mlflow": {"enabled": False},
        "output": {"root_dir": str(root / "runs")},
    }
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_and_validate_config(path)[0]
    gc.collect()
    gc.disable()
    trainer = Trainer(cfg, root / "runs" / name)
    trainer.fit()
    assert (root / "runs" / name / "report.json").is_file()
    alive = weakref.ref(trainer), weakref.ref(trainer.model)
    del trainer
    results[name] = [ref() is not None for ref in alive]
    gc.enable()
print(json.dumps(results))
"""


def test_finished_trainer_is_freed_without_the_collector(tmp_path) -> None:
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path, env=port_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    alive = json.loads(proc.stdout.strip().splitlines()[-1])
    assert alive == {"gpt": [False, False], "llama": [False, False]}, alive
