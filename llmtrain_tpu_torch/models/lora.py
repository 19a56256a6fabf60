"""LoRA fine-tuning over any model family (port of
``llmtrain_tpu/models/lora.py``).

The trainable state is the family's model, frozen, plus low-rank factors
``a`` (fan_in, rank) and ``b`` (rank, fan_out) for each adapted weight:
:class:`LoraModel` (JAX's ``init_lora``: ``a`` N(0, 1)/sqrt(fan_in),
``b`` zero). A forward runs the family's own module with each adapted
weight replaced by ``W + (alpha/rank) * A @ B`` (:meth:`LoraModel.
merged_weights`, JAX's ``merge_lora`` with ``stop_gradient`` on the
base). The base's parameters do not require gradients (JAX's
``lora_mask``), so it takes none, and the optimizer, built over the
parameters that do (training/optimizer.py), holds state for the factors
only and decays nothing else (JAX's ``lora_only_optimizer``).

Targets name the parent module of a weight as the JAX tree names it
(``qkv_proj``/``q_proj``/``kv_proj``/``out_proj`` by default, ``mlp_*``,
``lm_head``, ``token_embedding``); a weight is adapted when its module is a
target and it is a Linear's kernel or an embedding table. The fan-in and
fan-out are those of the flax kernel: a Linear's ``in_features`` and
``out_features`` (``out_proj`` contracts its (H, Dh) dims), an
embedding's rows and width. So the factors are JAX's, leaf for leaf, and
a checkpoint holds JAX's ``{"base": <family tree>, "lora": <factor
tree>}`` (interop/flax_params.py).

Config surface (any family)::

    model:
      extra:
        lora: {rank: 8, alpha: 16}            # defaults target attention
        # lora: {rank: 8, alpha: 16, targets: [qkv_proj, out_proj, mlp_fc]}

``generate``, ``serve``, ``eval`` and ``export-checkpoint`` merge on load
(:func:`to_inference_model`, JAX's ``to_inference_params``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Iterator

import torch
from torch import nn

from ..config.schemas import RunConfig
from .base import Batch, Metrics, ModelAdapter

# Attention projections: the classic LoRA target set, shared by every
# family (models/gpt.py, models/llama.py, GQA included).
DEFAULT_TARGETS = ("qkv_proj", "q_proj", "kv_proj", "out_proj")
# Key separator of the factor tree's paths in the port's parameter names
# (torch parameter names cannot hold "."): "block_0/attn/qkv_proj/kernel".
PATH_SEP = "/"


@dataclass(frozen=True)
class LoraSpec:
    rank: int
    alpha: float
    targets: tuple[str, ...]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def from_extra(cls, extra: dict) -> "LoraSpec | None":
        """Parse ``model.extra.lora``; None when absent (LoRA off)."""
        raw = extra.get("lora")
        if raw is None:
            return None
        if not isinstance(raw, dict):
            raise ValueError(f"model.extra.lora must be a mapping, got {type(raw).__name__}")
        unknown = sorted(set(raw) - {"rank", "alpha", "targets"})
        if unknown:
            raise ValueError(
                f"model.extra.lora: unknown keys {unknown}; expected rank/alpha/targets"
            )
        rank = int(raw.get("rank", 8))
        if rank < 1:
            raise ValueError(f"model.extra.lora.rank must be >= 1, got {rank}")
        alpha = float(raw.get("alpha", 2.0 * rank))
        if alpha <= 0:
            raise ValueError(f"model.extra.lora.alpha must be > 0, got {alpha}")
        raw_targets = raw.get("targets", DEFAULT_TARGETS)
        if (
            not isinstance(raw_targets, (list, tuple))
            or not raw_targets
            or not all(isinstance(t, str) and t for t in raw_targets)
        ):
            # A YAML string would otherwise explode into characters.
            raise ValueError("model.extra.lora.targets must be a non-empty list of module names")
        return cls(rank=rank, alpha=alpha, targets=tuple(raw_targets))


def flax_path(name: str, module: nn.Module) -> tuple[str, ...]:
    """The JAX tree path of the port's parameter ``name`` whose owning
    module is ``module``: ``blocks.{i}`` is ``block_{i}``, a Linear's
    weight its ``kernel``, an embedding's its ``embedding``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}", *parts[2:]]
    if isinstance(module, nn.Embedding):
        leaf = "embedding"
    elif isinstance(module, nn.Linear):
        leaf = "kernel" if parts[-1] == "weight" else "bias"
    else:
        leaf = parts[-1]
    return (*parts[:-1], leaf)


@dataclass(frozen=True)
class _Target:
    name: str  # the base model's parameter name
    path: tuple[str, ...]  # its JAX tree path
    embedding: bool  # (V, d) table: the delta is A @ B untransposed


def lora_targets(model: nn.Module, spec: LoraSpec) -> list[_Target]:
    """The adapted weights of ``model`` in parameter order (JAX
    ``_target_entry``: the parent module named in ``spec.targets``, a
    ``kernel`` or ``embedding`` leaf of two or more dims). Raises JAX's
    error when nothing matches."""
    modules = dict(model.named_modules())
    found: list[_Target] = []
    factorable: set[str] = set()
    for name, p in model.named_parameters():
        owner = modules[name.rpartition(".")[0]]
        path = flax_path(name, owner)
        if path[-1] not in ("kernel", "embedding"):
            continue
        factorable.add(path[-2])
        if path[-2] in spec.targets and p.dim() >= 2:
            found.append(_Target(name, path, isinstance(owner, nn.Embedding)))
    if not found:
        raise ValueError(
            f"model.extra.lora.targets {list(spec.targets)} matched no "
            f"parameters; factorable modules in this model: {sorted(factorable)}"
        )
    return found


def _fans(target: _Target, weight: torch.Tensor) -> tuple[int, int]:
    if target.embedding:
        return weight.shape[0], weight.shape[1]
    return weight.shape[1], weight.shape[0]


def _delta(target: _Target, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * A @ B`` in the layout of the port's weight: a Linear's
    (out, in) is the flax (in, out) kernel transposed."""
    delta = (a @ b) * scale
    return delta if target.embedding else delta.T


class LoraModel(nn.Module):
    """A frozen family model (``base``) and its LoRA factors (``lora``, a
    ParameterDict keyed by ``<JAX path>/a`` and ``<JAX path>/b``)."""

    def __init__(self, base: nn.Module, spec: LoraSpec, generator: torch.Generator) -> None:
        super().__init__()
        self.base = base
        self.spec = spec
        self.targets = lora_targets(base, spec)
        base.requires_grad_(False)
        weights = dict(base.named_parameters())
        self.lora = nn.ParameterDict()
        with torch.no_grad():
            for t in self.targets:
                w = weights[t.name]
                fan_in, fan_out = _fans(t, w)
                a = torch.randn(fan_in, spec.rank, generator=generator, device=w.device,
                                dtype=torch.float32) / math.sqrt(fan_in)
                key = PATH_SEP.join(t.path)
                self.lora[f"{key}{PATH_SEP}a"] = nn.Parameter(a.to(w.dtype))
                self.lora[f"{key}{PATH_SEP}b"] = nn.Parameter(
                    torch.zeros(spec.rank, fan_out, dtype=w.dtype, device=w.device))

    def factors(self, target: _Target) -> tuple[torch.Tensor, torch.Tensor]:
        key = PATH_SEP.join(target.path)
        return self.lora[f"{key}{PATH_SEP}a"], self.lora[f"{key}{PATH_SEP}b"]

    def merged_weights(self) -> dict[str, torch.Tensor]:
        """Each adapted weight as ``W + scale * A @ B`` in W's dtype (JAX
        ``merge_lora``); gradients reach the factors only."""
        weights = dict(self.base.named_parameters())
        out = {}
        for t in self.targets:
            w = weights[t.name]
            a, b = self.factors(t)
            out[t.name] = w.detach() + _delta(t, a, b, self.spec.scale).to(w.dtype)
        return out

    @contextlib.contextmanager
    def merged(self) -> Iterator[nn.Module]:
        """The base model with the merged weights in place of its own for
        the duration of the block (the family's module runs unchanged)."""
        from torch.nn.utils.stateless import _reparametrize_module

        with _reparametrize_module(self.base, self.merged_weights()):
            yield self.base

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        with self.merged() as base:
            return base(*args, **kwargs)

    @torch.no_grad()
    def merge_into_base(self) -> nn.Module:
        """Write the merged weights into the base model's own parameters
        and return it: the plain family model that inference runs."""
        for name, value in self.merged_weights().items():
            dict(self.base.named_parameters())[name].copy_(value)
        return self.base


class LoraAdapter(ModelAdapter):
    """Wraps any base adapter; its model is a :class:`LoraModel`."""

    def __init__(self, base: ModelAdapter, spec: LoraSpec) -> None:
        self._base = base
        self._spec = spec
        base_known = getattr(base, "known_extra_keys", None)
        self.known_extra_keys = None if base_known is None else frozenset(base_known) | {"lora"}

    @property
    def spec(self) -> LoraSpec:
        return self._spec

    @property
    def base(self) -> ModelAdapter:
        return self._base

    def build_model(self, cfg: RunConfig, device: torch.device | None = None) -> LoraModel:
        # The base is the one a run without LoRA builds from the seed; the
        # factors draw from a stream of their own.
        base = self._base.build_model(cfg, device)
        dev = next(base.parameters()).device
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.run.seed ^ 0x10A)
        return LoraModel(base, self._spec, generator).eval()

    def build_tokenizer(self, cfg: RunConfig) -> Any | None:
        return self._base.build_tokenizer(cfg)

    @staticmethod
    def _lora_model(model: nn.Module) -> LoraModel:
        if not isinstance(model, LoraModel):
            raise ValueError(
                "LoRA is enabled (model.extra.lora) but the parameter tree "
                "has no base/lora split — was this checkpoint trained "
                "without LoRA? Drop model.extra.lora to consume it."
            )
        return model

    def compute_loss(self, model: nn.Module, batch: Batch, *,
                     generator: torch.Generator | None = None,
                     deterministic: bool = True) -> tuple[torch.Tensor, Metrics]:
        with self._lora_model(model).merged() as base:
            return self._base.compute_loss(base, batch, generator=generator,
                                           deterministic=deterministic)

    def compute_loss_components(self, model: nn.Module, batch: Batch, *,
                                generator: torch.Generator | None = None,
                                deterministic: bool = True):
        with self._lora_model(model).merged() as base:
            return self._base.compute_loss_components(base, batch, generator=generator,
                                                      deterministic=deterministic)


def to_inference_model(model: nn.Module) -> nn.Module:
    """The merge-on-load rule in one place: a :class:`LoraModel` becomes
    its family model with the merged weights; any other model is itself."""
    return model.merge_into_base() if isinstance(model, LoraModel) else model


def inference_adapter(adapter: ModelAdapter) -> ModelAdapter:
    """The adapter that runs :func:`to_inference_model`'s output: a LoRA
    adapter's family adapter; any other adapter is itself."""
    return adapter.base if isinstance(adapter, LoraAdapter) else adapter


def build_adapter(cfg: RunConfig) -> ModelAdapter:
    """The one adapter factory: registry lookup plus the optional LoRA
    wrap, so ``model.extra.lora`` means the same everywhere."""
    from ..registry import get_model_adapter, initialize_registries

    initialize_registries()
    base = get_model_adapter(cfg.model.name)()
    spec = LoraSpec.from_extra(cfg.model.extra)
    if spec is None:
        return base
    return LoraAdapter(base, spec)


def lora_spec_error(cfg: RunConfig) -> str | None:
    """A malformed ``model.extra.lora`` as the message of a config error
    (exit 2; JAX ``_lora_spec_error``), else None."""
    try:
        LoraSpec.from_extra(cfg.model.extra)
    except ValueError as exc:
        return str(exc)
    return None


__all__ = [
    "DEFAULT_TARGETS",
    "LoraAdapter",
    "LoraModel",
    "LoraSpec",
    "build_adapter",
    "flax_path",
    "inference_adapter",
    "lora_spec_error",
    "lora_targets",
    "to_inference_model",
]
