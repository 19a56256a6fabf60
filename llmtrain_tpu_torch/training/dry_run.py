"""Forward-only dry run (port of ``llmtrain_tpu/training/dry_run.py``):
build the adapter and data module, run min(5, max_steps) forward-only
batches, log per-step loss and wall ms, and report the resolved plugin
names and the steps executed."""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..config.schemas import RunConfig
from ..data.sampler import DeterministicSampler
from ..distributed import resolve_device
from ..registry import get_data_module, get_model_adapter, initialize_registries
from ..utils.logging import get_logger
from .train_step import make_eval_step

DEFAULT_DRY_RUN_STEPS = 5

logger = get_logger()


@dataclass(frozen=True)
class DryRunResult:
    model_adapter: str
    data_module: str
    steps_executed: int


def run_dry_run(cfg: RunConfig) -> DryRunResult:
    """Run a few forward-only batches on the run's device."""
    from .trainer import refuse_unported

    refuse_unported(cfg)
    device = resolve_device(cfg.run.device)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
    data_module = get_data_module(cfg.data.name)()
    tokenizer = None
    try:
        tokenizer = adapter.build_tokenizer(cfg)
    except Exception as exc:  # noqa: BLE001 — offline environments: tokenizer optional
        logger.warning("build_tokenizer failed (%s); continuing without one", exc)
    data_module.setup(cfg, tokenizer)
    model = adapter.build_model(cfg, device)
    eval_step = make_eval_step(adapter, model)

    train_ds = data_module.train_dataset()
    steps = min(DEFAULT_DRY_RUN_STEPS, cfg.trainer.max_steps)
    sampler = DeterministicSampler(
        num_examples=len(train_ds),
        batch_size=min(cfg.trainer.micro_batch_size, len(train_ds)),
        seed=cfg.run.seed,
        shuffle=not cfg.run.deterministic,
    )
    for i in range(steps):
        start = time.perf_counter()
        host = train_ds.get_examples(sampler.batch_indices(i))
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        loss_sum, tokens = eval_step(batch)
        loss = float(loss_sum.sum()) / max(float(tokens.sum()), 1.0)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        logger.info("dry_run step=%d/%d loss=%.4f time_ms=%.1f", i + 1, steps, loss, elapsed_ms)
    return DryRunResult(
        model_adapter=cfg.model.name, data_module=cfg.data.name, steps_executed=steps
    )


__all__ = ["DEFAULT_DRY_RUN_STEPS", "DryRunResult", "run_dry_run"]
