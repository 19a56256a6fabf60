"""Mixture-of-Experts MLP, top-1 Switch or top-2 GShard routing (port of
``llmtrain_tpu/models/moe.py``).

The same math in the same layout as the JAX module: routing as dense
one-hot dispatch and combine tensors over (tokens, experts, capacity),
expert weights stacked (E, d_in, d_out) as flax stores them, and the
products as einsums. Plain PyTorch, as JAX's is plain XLA.

* ``router_top_k=1`` (Switch): each token goes to its argmax expert, its
  output scaled by the raw router probability.
* ``router_top_k=2`` (GShard): each token also goes to its second choice;
  the two raw probabilities are renormalised to sum to 1 before any
  capacity drop, and second choices queue behind every first choice.
* Capacity ``ceil(capacity_factor * k * T / n_experts)`` per sequence;
  a token over capacity is dropped (the MoE output is 0 for that choice,
  the residual carries it).
* The load-balance loss ``aux_weight * E^2 * mean(f * P)``, f from first
  choices, is kept on the module (:attr:`MoEMLP.aux_loss`) for the
  adapter to fold into the objective (:func:`take_aux_loss`), as JAX sows
  it into the ``losses`` collection.

Each choice is ``argmax`` over the probabilities not yet chosen, as JAX
takes it: ties go to the first index (``torch.argmax`` and
``jnp.argmax`` agree), where ``torch.topk`` promises no order. The
router runs in f32.

Under a mesh (distributed/mesh.py; JAX's ``expert``, ``act_expert`` and
``act_expert_group`` rules):

* ``expert_parallel`` x: each rank holds the weights of ``E/x`` experts;
  the router stays whole, every rank routes its own tokens over all E
  experts (so the capacity, the tokens dropped and the aux loss are
  JAX's), and the (E, B, C, d) expert inputs cross the expert group by
  all-to-all: each rank receives its experts' slots from every rank,
  runs them, and sends the outputs back by the inverse exchange;
* ``tensor_parallel`` t: the experts' mlp dim splits over the tensor
  axis (their input copied into the group, their outputs summed over it
  before the output bias);
* ``sequence_parallel`` s: routing sees whole sequences (the capacity is
  per sequence), so the layer runs on the gathered sequence and each rank
  keeps its rows.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import dequantized, expert_matmul

_INIT_STD = 0.02


def fill_constant(value: float) -> Any:
    """An init-plan fill: every element ``value`` (draws nothing)."""

    def fill(p: torch.Tensor, generator: torch.Generator) -> None:
        p.fill_(value)

    return fill


def fill_normal(std: float) -> Any:
    """An init-plan fill: N(0, ``std``) drawn from the generator."""

    def fill(p: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(p, 0.0, std, generator=generator)

    return fill


class MoEMLP(nn.Module):
    """Drop-in replacement for a block's dense MLP. ``mlp_type`` is
    ``gelu`` (the GPT family: biased two-matmul experts, exact GELU) or
    ``swiglu`` (the Mixtral layout: ``silu(x wg) * (x wu)`` then ``wo``,
    bias-free)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, router_top_k: int = 1,
                 mlp_type: str = "gelu", matmul_precision: str = "f32",
                 tensor_parallel: int = 1, expert_parallel: int = 1,
                 sequence_parallel: int = 1) -> None:
        super().__init__()
        self.ep = expert_parallel
        self.tp = tensor_parallel if d_ff % tensor_parallel == 0 else 1
        self.sp = sequence_parallel
        self.matmul_precision = matmul_precision
        if mlp_type not in ("gelu", "swiglu"):
            raise ValueError(f"mlp_type {mlp_type!r} unknown; expected 'gelu' or 'swiglu'")
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_top_k = router_top_k
        self.mlp_type = mlp_type
        self.dtype = dtype
        self.router = nn.Linear(d_model, n_experts, bias=False, dtype=torch.float32)

        def stacked(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype))

        local, ff = n_experts // expert_parallel, d_ff // self.tp
        if mlp_type == "swiglu":
            self.wg = stacked(local, d_model, ff)
            self.wu = stacked(local, d_model, ff)
        else:
            self.wi = stacked(local, d_model, ff)
            self.bi = stacked(local, ff)
        self.wo = stacked(local, ff, d_model)
        if mlp_type == "gelu":
            self.bo = stacked(local, d_model)
        self.aux_loss: torch.Tensor | None = None

    def init_plan(self, n_layers: int) -> list[tuple[str, Any]]:
        """JAX's initializers as (parameter name, fill) in draw order:
        N(0, 0.02) router and input experts, N(0, 0.02/sqrt(2 n_layers))
        ``wo``, zero biases (models/gpt.py ``GPT.init_plan``)."""
        plan = []
        for name, _ in self.named_parameters():
            if name in ("bi", "bo"):
                plan.append((name, fill_constant(0.0)))
            else:
                std = _INIT_STD / math.sqrt(2 * n_layers) if name == "wo" else _INIT_STD
                plan.append((name, fill_normal(std)))
        return plan

    def capacity(self, seqlen: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * self.router_top_k * seqlen
                                    / self.n_experts)))

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dispatch, combine, aux): the (B, T, E, C) f32 one-hot dispatch
        and combine tensors and the load-balance loss for ``x`` (B, T, d)."""
        batch, seqlen, _ = x.shape
        n_exp, k = self.n_experts, self.router_top_k
        if k not in (1, 2):
            raise ValueError(f"router_top_k must be 1 or 2, got {k}")
        if k > n_exp:
            raise ValueError(f"router_top_k {k} exceeds n_experts {n_exp}")
        capacity = self.capacity(seqlen)
        gates = torch.softmax(F.linear(x.float(), dequantized(self.router.weight).float()),
                              dim=-1)

        remaining = gates
        queued = gates.new_zeros(batch, n_exp)
        choices = []  # (mask after the cut, raw probability, kept, position)
        first_choice = None
        for _ in range(k):
            mask_pre = F.one_hot(torch.argmax(remaining, dim=-1), n_exp).to(gates.dtype)
            if first_choice is None:
                first_choice = mask_pre
            pos = (torch.cumsum(mask_pre, dim=1) + queued[:, None, :]) * mask_pre
            mask_post = mask_pre * (pos <= capacity)
            raw_prob = (remaining * mask_pre).sum(dim=-1)
            kept = mask_post.sum(dim=-1)
            position = (pos * mask_post).sum(dim=-1) - 1.0
            choices.append((mask_post, raw_prob, kept, position))
            queued = queued + mask_post.sum(dim=1)
            remaining = remaining * (1.0 - mask_pre)

        density = first_choice.mean(dim=1)
        density_proxy = gates.mean(dim=1)
        aux = self.aux_loss_weight * n_exp * n_exp * torch.mean(density * density_proxy)

        if k == 1:
            weights = [p * kp for _, p, kp, _ in choices]
        else:
            denom = torch.clamp_min(sum(p for _, p, _, _ in choices), 1e-9)
            weights = [p / denom * kp for _, p, kp, _ in choices]

        slots = torch.arange(capacity, device=x.device, dtype=gates.dtype)
        dispatch = gates.new_zeros(batch, seqlen, n_exp, capacity)
        combine = gates.new_zeros(batch, seqlen, n_exp, capacity)
        for (mask_i, _, _, position_i), weight_i in zip(choices, weights):
            # A dropped token's position is -1: its one-hot row is all zero
            # (jax.nn.one_hot of an index out of range).
            position_oh = (position_i[..., None] == slots).to(gates.dtype)
            dispatch_i = mask_i[..., None] * position_oh[:, :, None, :]
            dispatch = dispatch + dispatch_i
            combine = combine + dispatch_i * weight_i[:, :, None, None]
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sp > 1:
            from ..distributed import active_mesh
            from ..parallel.collectives import gather_rs, slice_dim

            group = active_mesh().group("sequence")
            return slice_dim(self._forward(gather_rs(x, 1, group)), 1, group)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..distributed import active_mesh
        from ..parallel.collectives import all_to_all, copy_to, reduce_from

        mesh = active_mesh() if self.ep > 1 or self.tp > 1 else None
        ep_group = mesh.group("expert") if self.ep > 1 else None
        tp_group = mesh.group("tensor") if self.tp > 1 else None
        dispatch, combine, aux = self.route(x)
        self.aux_loss = aux
        expert_in = torch.einsum("btec,btd->ebcd", dispatch.to(x.dtype), copy_to(x, tp_group))
        # Expert parallelism: (E, B, C, d) -> this rank's E/x experts for
        # every rank's rows, (E/x, x·B, C, d).
        expert_in = all_to_all(expert_in, 0, 1, ep_group)

        def w(name: str) -> torch.Tensor:
            # int8 serving weights (ops/quant.py) are dequantized at use.
            return dequantized(getattr(self, name)).to(self.dtype)

        def dot(x: torch.Tensor, name: str) -> torch.Tensor:
            # The expert products in the quantized modes (JAX _expert_matmul).
            return expert_matmul(x, w(name), self.matmul_precision)

        if self.mlp_type == "swiglu":
            gate, up = dot(expert_in, "wg"), dot(expert_in, "wu")
            expert_out = reduce_from(dot(F.silu(gate) * up, "wo"), tp_group)
        else:
            h = dot(expert_in, "wi")
            h = F.gelu(h + w("bi")[:, None, None, :], approximate="none")
            expert_out = reduce_from(dot(h, "wo"), tp_group)
            expert_out = expert_out + w("bo")[:, None, None, :]
        expert_out = all_to_all(expert_out, 1, 0, ep_group)
        return torch.einsum("btec,ebcd->btd", combine.to(x.dtype), expert_out)


def take_aux_loss(model: nn.Module) -> torch.Tensor | None:
    """The sum of the load-balance losses the model's MoE layers kept in
    its last forward (JAX: the sown ``losses`` collection), clearing them;
    None for a model without MoE layers."""
    total = None
    for module in model.modules():
        if isinstance(module, MoEMLP) and module.aux_loss is not None:
            total = module.aux_loss if total is None else total + module.aux_loss
            module.aux_loss = None
    return total


__all__ = ["MoEMLP", "take_aux_loss"]
