"""Optimizers and the LR schedule (port of ``llmtrain_tpu/training/optimizer.py``).

The JAX trainer builds ``optax.chain(clip_by_global_norm(max_grad_norm),
<rule>[, param EMA])``. This module applies the same updates to torch
tensors in optax's order of operations (``torch.optim.AdamW`` orders its
decay differently). Every rule starts with the clip: with ``n`` the global
norm of the gradients, gradients pass unchanged when ``n < max_norm``,
else become ``(g / n) * max_norm``. The schedule is read at the count of
updates applied before this one (0 for the first). The rules
(``trainer.extra.optimizer``):

* ``adamw`` (default; optax ``adamw(b1=0.9, b2=0.999, eps=1e-8, wd)``):
  ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias-corrected
  with ``1 - b^t``, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd * p`` (decay on
  every parameter), ``p = p - lr * u``;
* ``adafactor`` (optax ``adafactor(multiply_by_parameter_scale=False,
  clipping_threshold=1.0, weight_decay_rate=None)``): the factored
  second moment of ``scale_by_factored_rms`` (decay ``1 - (t+1)^-0.8``,
  eps 1e-30 added to g^2; a tensor whose second-largest dim is >= 128 keeps
  row and column means along its two largest dims, any other a full
  moment), then the per-tensor ``clip_by_block_rms(1.0)``, then
  ``-lr * u``, then the decoupled decay ``- lr * wd * p`` when wd != 0
  (JAX's ``_scheduled_decoupled_decay``). Adafactor factors the JAX
  package's parameter shapes, so it runs on views of the port's tensors in
  that layout (``views``; interop/flax_params.py ``flax_layout_views``);
* ``lion`` (optax ``lion(b1=0.9, b2=0.99, wd)``): ``u = sign(b1 mu +
  (1 - b1) g)``, ``mu = b2 mu + (1 - b2) g``, ``p = p - lr * (u + wd * p)``.

Under the non-finite guard (``step(grads, apply=flag)``, the flag a device
bool) every write of an update is a device-side select between the new
value and the old one, so a skipped update leaves the parameters, the
moments and the EMA bit-identical with no host read in the step; the
update count (which the schedule and the bias corrections read on the
host) then advances by the flag, read once, at the start of the next
update, when the device has long computed it (:meth:`_Optimizer.settle`).

``trainer.extra.ema_decay`` (JAX ``_param_ema``, chained last) keeps an f32
shadow ``ema = d * ema + (1 - d) * p`` of the updated parameters; it never
changes an update. A (1 - d) step is below bf16's resolution, so the
shadow is f32 whatever the parameters' dtype.

Optimizer state (the port's own layout; checkpoints carry it as
``opt_state``, neither package resumes the other's): ``count`` plus, keyed
by the port's parameter names, ``mu``/``nu`` (adamw), ``mu`` (lion), or
``v_row``/``v_col`` for factored and ``v`` for unfactored tensors
(adafactor), and the shadow under :data:`EMA_STATE_KEY`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..config.schemas import RunConfig, TrainerConfig

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_LION_B1, _LION_B2 = 0.9, 0.99
_AF_DECAY, _AF_MIN_DIM, _AF_EPS, _AF_CLIP = 0.8, 128, 1e-30, 1.0

# The key of the EMA shadow inside a serialized opt_state (JAX's), so a
# checkpoint reader finds it without knowing the optimizer's layout.
EMA_STATE_KEY = "__param_ema__"

View = Callable[[torch.Tensor], torch.Tensor]


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


def ema_decay_of(cfg: TrainerConfig) -> float | None:
    """``trainer.extra.ema_decay`` checked as JAX checks it, or None."""
    decay = cfg.extra.get("ema_decay")
    if decay is None:
        return None
    decay = float(decay)
    if not 0.0 < decay < 1.0:
        raise ValueError(f"trainer.extra.ema_decay must be in (0, 1), got {decay}")
    return decay


def _host(tensors: list[torch.Tensor], names: list[str]) -> dict[str, Any]:
    """Host copies keyed by name: numpy, or a CPU tensor for bfloat16
    (numpy has no such dtype; the checkpoint writer takes both)."""
    return {n: _host_one(t) for n, t in zip(names, tensors)}


def _host_one(t: torch.Tensor) -> Any:
    """An owned host copy (one copy, on or off the card): a checkpoint
    written on a thread must not see the next update's in-place writes."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _load_into(targets: list[torch.Tensor], names: list[str], stored: Any, what: str) -> None:
    if not isinstance(stored, dict) or set(names) - set(stored):
        missing = sorted(set(names) - set(stored or {}))
        raise ValueError(f"optimizer state lacks {what} for parameters: {missing}")
    for n, t in zip(names, targets):
        t.copy_(_as_tensor(stored[n]))


class _Optimizer:
    """Clip-by-global-norm → the rule (:meth:`_update`) → the EMA, over a
    model's named parameters, updating them in place under no_grad."""


    def __init__(self, named_params: list[tuple[str, torch.nn.Parameter]],
                 cfg: TrainerConfig) -> None:
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.max_norm = float(cfg.max_grad_norm)
        self.weight_decay = float(cfg.weight_decay)
        self.schedule = lr_schedule(cfg)
        self._count = 0
        self.ema_decay = ema_decay_of(cfg)
        self.ema: list[torch.Tensor] | None = None
        if self.ema_decay is not None:
            self.ema = [p.detach().float().clone() for p in self.params]
        # The guard's flag of the last update, not yet folded into count.
        self._pending: torch.Tensor | None = None
        self._apply: torch.Tensor | None = None

    def _update(self, grads: Iterator[torch.Tensor], lr: float) -> None:
        """Apply the rule to the clipped gradients (in parameter order),
        writing through :meth:`_put` and :meth:`_add`."""
        raise NotImplementedError

    def _put(self, dst: torch.Tensor, value: torch.Tensor) -> None:
        """``dst = value``, or under the guard's flag the old ``dst`` where
        the flag is false (selected into ``dst`` in one launch when the
        dtypes agree)."""
        if self._apply is None:
            dst.copy_(value)
        elif value.dtype == dst.dtype:
            torch.where(self._apply, value, dst, out=dst)
        else:
            dst.copy_(torch.where(self._apply, value, dst))

    def _add(self, dst: torch.Tensor, inc: torch.Tensor) -> None:
        """``dst += inc``, under the guard's flag as :meth:`_put`."""
        if self._apply is None:
            dst.add_(inc)
        else:
            self._put(dst, dst + inc)

    @property
    def count(self) -> int:
        """Updates applied so far (optax's count): reading it folds in the
        last guarded update's flag (:meth:`settle`)."""
        self.settle()
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._pending = None
        self._count = int(value)

    def settle(self) -> None:
        """Fold the last guarded update's flag into the count (one host
        read of a device bool, long computed by the time it is called)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._count += int(pending)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], apply: torch.Tensor | None = None) -> None:
        """One update from ``grads`` (one per parameter, in order). With
        ``apply`` (the non-finite guard's device bool) the update is kept
        only where it is true, and ``count`` advances by it."""
        self.settle()
        g_norm = global_norm(grads)
        trigger = g_norm < self.max_norm
        one = torch.ones((), dtype=torch.float32, device=g_norm.device)
        # Unclipped: g / 1 * 1 (exact); clipped: (g / n) * max_norm.
        div = torch.where(trigger, one, g_norm)
        mul = torch.where(trigger, one, torch.full_like(one, self.max_norm))
        clipped = ((g / div.to(g.dtype)) * mul.to(g.dtype) for g in grads)
        self._apply = apply
        try:
            self._update(clipped, self.schedule(self.count))
            if self.ema is not None:
                # d * ema + (1 - d) * p, as multi-tensor ops (a few launches
                # for all the parameters).
                if apply is None:
                    torch._foreach_mul_(self.ema, self.ema_decay)
                    torch._foreach_add_(self.ema, [p.float() for p in self.params],
                                        alpha=1.0 - self.ema_decay)
                else:
                    new = torch._foreach_mul(self.ema, self.ema_decay)
                    torch._foreach_add_(new, [p.float() for p in self.params],
                                        alpha=1.0 - self.ema_decay)
                    for e, n in zip(self.ema, new):
                        self._put(e, n)
        finally:
            self._apply = None
        if apply is None:
            self._count += 1
        else:
            self._pending = apply

    def state_tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor of the optimizer's state (moments, factored
        moments, the EMA shadow), for the memory accounting."""
        for key, value in vars(self).items():
            if key == "params":
                continue
            items = value.values() if isinstance(value, dict) else (
                value if isinstance(value, list) else ())
            for t in items:
                if isinstance(t, torch.Tensor):
                    yield t

    def _state(self) -> dict[str, Any]:
        raise NotImplementedError

    def _load(self, state: dict[str, Any]) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict[str, Any]:
        """The state as host numpy, keyed by parameter name (module doc)."""
        out = {"count": np.int32(self.count), **self._state()}
        if self.ema is not None:
            out[EMA_STATE_KEY] = _host(self.ema, self.names)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s layout (every parameter present)."""
        self._load(state)
        if self.ema is not None:
            if EMA_STATE_KEY not in state:
                raise ValueError(
                    "checkpoint holds no EMA state — train with "
                    "trainer.extra.ema_decay to track shadow weights"
                )
            _load_into(self.ema, self.names, state[EMA_STATE_KEY], "the EMA shadow")
        self.count = int(state["count"])



class AdamW(_Optimizer):
    """optax ``adamw`` (module doc)."""


    def __init__(self, named_params, cfg: TrainerConfig) -> None:
        super().__init__(named_params, cfg)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _update(self, grads, lr):
        t = self.count + 1
        # 1 - b^t in float32, as optax computes it.
        bc1 = float(1 - np.float32(_B1) ** np.float32(t))
        bc2 = float(1 - np.float32(_B2) ** np.float32(t))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            self._put(mu, (1 - _B1) * g + _B1 * mu)
            self._put(nu, (1 - _B2) * (g * g) + _B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            u = u + self.weight_decay * p
            self._add(p, (-lr) * u)

    def _state(self):
        return {"mu": _host(self.mu, self.names), "nu": _host(self.nu, self.names)}

    def _load(self, state):
        _load_into(self.mu, self.names, state.get("mu"), "mu")
        _load_into(self.nu, self.names, state.get("nu"), "nu")



class Lion(_Optimizer):
    """optax ``lion(b1=0.9, b2=0.99, weight_decay)`` (module doc)."""


    def __init__(self, named_params, cfg: TrainerConfig) -> None:
        super().__init__(named_params, cfg)
        self.mu = [torch.zeros_like(p) for p in self.params]

    def _update(self, grads, lr):
        for p, g, mu in zip(self.params, grads, self.mu):
            u = torch.sign((1.0 - _LION_B1) * g + _LION_B1 * mu)
            self._put(mu, (1 - _LION_B2) * g + _LION_B2 * mu)
            u = u + self.weight_decay * p
            self._add(p, (-lr) * u)

    def _state(self):
        return {"mu": _host(self.mu, self.names)}

    def _load(self, state):
        _load_into(self.mu, self.names, state.get("mu"), "mu")



def factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: (second-largest, largest) dim of a tensor
    whose second-largest dim is >= 128, else None (a full moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _AF_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Optimizer):
    """optax ``adafactor`` as the JAX trainer configures it (module doc).
    ``views`` maps a parameter name to the view of a tensor in the JAX
    package's layout, where the factoring is decided (identity when
    absent)."""


    def __init__(self, named_params, cfg: TrainerConfig,
                 views: dict[str, View] | None = None) -> None:
        super().__init__(named_params, cfg)
        identity: View = lambda t: t  # noqa: E731
        self.views = [(views or {}).get(n, identity) for n in self.names]
        self.dims: list[tuple[int, int] | None] = []
        self.v_row: dict[int, torch.Tensor] = {}
        self.v_col: dict[int, torch.Tensor] = {}
        self.v: dict[int, torch.Tensor] = {}
        for i, (p, view) in enumerate(zip(self.params, self.views)):
            pv = view(p.detach())
            dims = factored_dims(tuple(pv.shape))
            self.dims.append(dims)
            if dims is None:
                self.v[i] = torch.zeros_like(pv, memory_format=torch.contiguous_format)
            else:
                d1, d0 = dims
                self.v_row[i] = torch.zeros_like(pv.mean(dim=d0))
                self.v_col[i] = torch.zeros_like(pv.mean(dim=d1))

    def _update(self, grads, lr):
        t = np.float32(self.count + 1)
        decay = np.float32(1.0) - t ** np.float32(-_AF_DECAY)
        keep, add = float(decay), float(np.float32(1.0) - decay)
        for i, (p, g, view, dims) in enumerate(zip(self.params, grads, self.views, self.dims)):
            gv = view(g).float()
            g_sq = gv * gv + _AF_EPS
            if dims is None:
                v = self.v[i]
                self._put(v, keep * v.float() + add * g_sq)
                u = gv * v.float() ** -0.5
            else:
                d1, d0 = dims
                vr, vc = self.v_row[i], self.v_col[i]
                self._put(vr, keep * vr.float() + add * g_sq.mean(dim=d0))
                self._put(vc, keep * vc.float() + add * g_sq.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = vr.float().mean(dim=reduced_d1, keepdim=True)
                row_factor = (vr.float() / row_col_mean) ** -0.5
                col_factor = vc.float() ** -0.5
                u = gv * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            # clip_by_block_rms, then the lr (optax scales then flips the sign).
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / _AF_CLIP, min=1.0)
            u = -(lr * u)
            pv = view(p)
            if self.weight_decay:
                u = u - float(np.float32(lr) * np.float32(self.weight_decay)) * pv.float()
            self._add(pv, u.to(p.dtype))

    def _state(self):
        def pick(store: dict[int, torch.Tensor]) -> dict[str, Any]:
            return {self.names[i]: _host_one(t) for i, t in store.items()}

        return {"v_row": pick(self.v_row), "v_col": pick(self.v_col), "v": pick(self.v)}

    def _load(self, state):
        for key, store in (("v_row", self.v_row), ("v_col", self.v_col), ("v", self.v)):
            names = [self.names[i] for i in store]
            _load_into(list(store.values()), names, state.get(key), key)



def build_optimizer(
    cfg: TrainerConfig,
    named_params: list[tuple[str, torch.nn.Parameter]],
    *,
    views: dict[str, View] | None = None,
) -> _Optimizer:
    """``trainer.extra.optimizer`` (default ``adamw``) → the optimizer, with
    the EMA when ``trainer.extra.ema_decay`` is set (JAX's ``ValueError``
    outside (0, 1), and for an unknown name)."""
    name = str(cfg.extra.get("optimizer", "adamw"))
    ema_decay_of(cfg)
    if name == "adamw":
        return AdamW(named_params, cfg)
    if name == "adafactor":
        return Adafactor(named_params, cfg, views=views)
    if name == "lion":
        return Lion(named_params, cfg)
    raise ValueError(
        f"trainer.extra.optimizer {name!r} unknown; expected 'adamw', "
        "'adafactor', or 'lion'"
    )


def build_model_optimizer(cfg: RunConfig, model: torch.nn.Module) -> _Optimizer:
    """The run's optimizer over ``model``'s parameters, Adafactor given the
    views of the JAX package's layout."""
    from ..interop.flax_params import flax_layout_views

    named = list(model.named_parameters())
    views = flax_layout_views(named, n_heads=cfg.model.n_heads,
                              n_kv_heads=int(cfg.model.extra.get("n_kv_heads", 0)))
    return build_optimizer(cfg.trainer, named, views=views)


def find_ema_tree(opt_state: Any) -> Any:
    """The EMA shadow inside a serialized optimizer state (nested dicts,
    lists or tuples; JAX's ``find_ema_tree``), or None."""
    if isinstance(opt_state, dict):
        if EMA_STATE_KEY in opt_state:
            return opt_state[EMA_STATE_KEY]
        children = opt_state.values()
    elif isinstance(opt_state, (tuple, list)):
        children = opt_state
    else:
        return None
    for child in children:
        hit = find_ema_tree(child)
        if hit is not None:
            return hit
    return None


__all__ = [
    "EMA_STATE_KEY",
    "AdamW",
    "Adafactor",
    "Lion",
    "build_model_optimizer",
    "build_optimizer",
    "ema_decay_of",
    "factored_dims",
    "find_ema_tree",
    "global_norm",
    "lr_schedule",
]
