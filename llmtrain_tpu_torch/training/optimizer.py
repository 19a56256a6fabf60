"""Optimizer and LR schedule (port of ``llmtrain_tpu/training/optimizer.py``).

The JAX trainer builds ``optax.chain(clip_by_global_norm(max_grad_norm),
optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay))``. This
module applies the same update to torch tensors in the same order of
operations (``torch.optim.AdamW`` orders its decay differently):

1. clip: with ``n`` the global norm of the gradients, gradients pass
   unchanged when ``n < max_norm``, else become ``(g / n) * max_norm``;
2. Adam moments: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
   bias-corrected with ``1 - b^t`` (t = updates applied so far + 1),
   ``u = mu_hat / (sqrt(nu_hat) + eps)``;
3. decoupled weight decay on EVERY parameter (optax has no mask here):
   ``u = u + weight_decay * p``;
4. ``p = p - lr(count) * u`` with the schedule read at the count of
   updates applied before this one (0 for the first).

Optimizer state layout (the port's own; checkpoints carry it as
``opt_state``): ``{"count": int32, "mu": {name: array}, "nu": {name:
array}}`` keyed by the port's parameter names (``model.named_parameters``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from ..config.schemas import TrainerConfig

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def lr_schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    """Linear warmup → cosine decay to 0, as a function of the update
    count, computed in float32 as the JAX schedule is."""
    warmup = cfg.warmup_steps
    max_steps = cfg.max_steps
    base_lr = np.float32(cfg.lr)

    def schedule(count: int) -> float:
        c = np.float32(count)
        if count < warmup:
            mult = c / np.float32(warmup)
        elif max_steps <= warmup:
            mult = np.float32(1.0)
        else:
            progress = (c - np.float32(warmup)) / np.float32(max_steps - warmup)
            progress = np.clip(progress, np.float32(0.0), np.float32(1.0))
            mult = np.float32(0.5) * (
                np.float32(1.0) + np.cos(np.float32(math.pi) * progress, dtype=np.float32)
            )
        return float(base_lr * np.float32(mult))

    return schedule


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW:
    """Clip-by-global-norm → AdamW with the warmup-cosine schedule, in
    optax's order of operations, over a model's named parameters. Updates
    the parameters in place under ``torch.no_grad``."""

    def __init__(self, named_params: list[tuple[str, torch.nn.Parameter]],
                 cfg: TrainerConfig) -> None:
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.max_norm = float(cfg.max_grad_norm)
        self.weight_decay = float(cfg.weight_decay)
        self.schedule = lr_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        g_norm = global_norm(grads)
        trigger = g_norm < self.max_norm
        one = torch.ones((), dtype=torch.float32, device=g_norm.device)
        # Unclipped: g / 1 * 1 (exact); clipped: (g / n) * max_norm.
        div = torch.where(trigger, one, g_norm)
        mul = torch.where(trigger, one, torch.full_like(one, self.max_norm))
        t = self.count + 1
        # 1 - b^t in float32, as optax computes it.
        bc1 = float(1 - np.float32(_B1) ** np.float32(t))
        bc2 = float(1 - np.float32(_B2) ** np.float32(t))
        lr = self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = (g / div.to(g.dtype)) * mul.to(g.dtype)
            mu.copy_((1 - _B1) * g + _B1 * mu)
            nu.copy_((1 - _B2) * (g * g) + _B2 * nu)
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            u = mu_hat / (torch.sqrt(nu_hat) + _EPS)
            u = u + self.weight_decay * p
            p.add_((-lr) * u)
        self.count = t

    def state_dict(self) -> dict[str, Any]:
        """The state as host numpy, keyed by parameter name (module doc)."""
        return {
            "count": np.int32(self.count),
            "mu": {n: m.detach().cpu().numpy() for n, m in zip(self.names, self.mu)},
            "nu": {n: v.detach().cpu().numpy() for n, v in zip(self.names, self.nu)},
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s layout (every parameter present)."""
        missing = set(self.names) - set(state["mu"]) | set(self.names) - set(state["nu"])
        if missing:
            raise ValueError(f"optimizer state lacks parameters: {sorted(missing)}")
        for n, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(_as_tensor(state["mu"][n]))
            nu.copy_(_as_tensor(state["nu"][n]))
        self.count = int(state["count"])


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def build_optimizer(
    cfg: TrainerConfig, named_params: list[tuple[str, torch.nn.Parameter]]
) -> AdamW:
    """``trainer.extra.optimizer`` (default ``adamw``) → the optimizer.
    ``adafactor``, ``lion`` and ``trainer.extra.ema_decay`` are not yet
    ported; an unknown name raises as in JAX."""
    name = str(cfg.extra.get("optimizer", "adamw"))
    if cfg.extra.get("ema_decay") is not None:
        raise NotImplementedError(
            "trainer.extra.ema_decay (EMA shadow weights) is not yet ported to "
            "llmtrain_tpu_torch (ROADMAP.md queue A: slice 2 deferrals)"
        )
    if name in ("adafactor", "lion"):
        raise NotImplementedError(
            f"trainer.extra.optimizer={name!r} is not yet ported to llmtrain_tpu_torch "
            "(ROADMAP.md queue A: slice 2 deferrals); use 'adamw'"
        )
    if name != "adamw":
        raise ValueError(
            f"trainer.extra.optimizer {name!r} unknown; expected 'adamw', "
            "'adafactor', or 'lion'"
        )
    return AdamW(named_params, cfg)


__all__ = ["AdamW", "build_optimizer", "global_norm", "lr_schedule"]
