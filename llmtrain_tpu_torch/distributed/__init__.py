"""Device selection for the port's entry points.

Counterpart of ``configure_platform`` (llmtrain_tpu/distributed/
__init__.py:119): ``run.device: "cpu"`` runs on the CPU; ``"tpu"`` (the
value the existing presets carry) and ``"cuda"`` run on the card. When
the card is asked for and none is visible the entry point raises — it
never continues on the CPU. Multi-process setup comes with the training
slice.
"""

from __future__ import annotations

import torch


def resolve_device(device: str) -> torch.device:
    """``run.device`` → the torch device an entry point runs on."""
    if device == "cpu":
        return torch.device("cpu")
    if device in ("tpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"run.device is {device!r}, which runs on the card, but "
                "torch.cuda.is_available() is False; set run.device: \"cpu\" "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown run.device {device!r}; expected cpu, tpu or cuda")


__all__ = ["resolve_device"]
