"""Weight-only int8 quantization for serving (port of the serving half of
``llmtrain_tpu/ops/quant.py``).

One recipe, :func:`quantize_array`: symmetric per-channel int8 with
``scale = amax / 127`` over the reduced axes (a channel that is all zero
gets scale 1.0), codes ``round(w / scale)`` in f32, rounding half to even.
It quantizes weight matrices here and the int8 decode cache of
``models/gpt.py``.

:func:`quantize_tree` applies JAX's selection rules to the port's
parameter names: a leaf is quantized iff it is floating, at least 2-D, of
``min_size`` elements or more and not a bias; embedding tables get one
scale per row; every other kernel one scale per unit of flax's largest
leading axis. For the port's (out, in) ``nn.Linear`` weights that is the
input axis, so each output channel gets one scale, except ``out_proj``,
whose flax kernel is (H, Dh, D): its input splits into heads and head
dims, and the scale runs over the larger of the two (heads on a tie), as
JAX's does. :class:`QuantizedArray` keeps such a weight's codes in the
torch layout and its scale broadcastable to a view of them.

:func:`quantize_model` installs the quantized leaves on a GPT in place of
its parameters; the model dequantizes each one to the original dtype at
its use (JAX's ``__jax_array__``), so the int8 codes are what stays
resident. The training half (``fake_quant``, the fp8 and int8 matmuls,
``QuantDense``) is not ported yet (ROADMAP.md queue A: parallelism).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

_INT8_MAX = 127.0


class QuantizedArray:
    """int8 codes + broadcastable f32 scales, standing for a tensor of
    ``dtype`` and the codes' shape. ``view`` is the shape the codes take
    for the scale to broadcast (the codes' own shape by default)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                 view: tuple[int, ...] | None = None) -> None:
        self.q = q
        self.scale = scale
        self.dtype = dtype
        self.view = tuple(q.shape) if view is None else tuple(view)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    def numel(self) -> int:
        return self.q.numel()

    @property
    def nbytes(self) -> int:
        """Actual storage cost: int8 codes + scale floats."""
        return self.q.numel() + self.scale.numel() * self.scale.element_size()

    def dequantize(self) -> torch.Tensor:
        """``codes * scale`` in f32, then the original dtype."""
        return (self.q.view(self.view).float() * self.scale).view(self.q.shape).to(self.dtype)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"QuantizedArray(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"scale_shape={tuple(self.scale.shape)})")


def quantize_array(w: torch.Tensor, *, reduce_axes: tuple[int, ...],
                   view: tuple[int, ...] | None = None) -> QuantizedArray:
    """Symmetric per-channel int8: ``scale = amax/127`` over ``reduce_axes``
    of ``w`` (of ``w.view(view)`` when given)."""
    wf = w.float() if view is None else w.float().view(view)
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    # All-zero channels get scale 1.0: their codes are 0 either way, without
    # a 0/0 NaN in the division.
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / _INT8_MAX)
    q = torch.clamp(torch.round(wf / scale), -_INT8_MAX, _INT8_MAX)
    return QuantizedArray(q.to(torch.int8).view(w.shape), scale, w.dtype, view)


def _quantize_leaf(name: str, a: torch.Tensor, n_heads: int) -> QuantizedArray:
    """JAX's per-channel rule on the flax layout of the port's ``name``."""
    if "embedding" in name:
        return quantize_array(a, reduce_axes=(a.ndim - 1,))  # one scale per row
    if name.endswith("attn.out_proj.weight"):
        # flax (H, Dh, D): the larger of H and Dh (H on a tie) is reduced.
        d, width = a.shape
        view = (d, n_heads, width // n_heads)
        return quantize_array(a, reduce_axes=(1 if view[1] >= view[2] else 2,), view=view)
    if ".moe_mlp." in name and not name.endswith("router.weight"):
        # Stacked experts keep flax's layout: the largest leading axis.
        leading = a.shape[:-1]
        return quantize_array(a, reduce_axes=(leading.index(max(leading)),))
    return quantize_array(a, reduce_axes=(1,))  # the (out, in) weight's input axis


def quantize_tree(params: dict[str, Any], *, n_heads: int, min_size: int = 4096) -> dict[str, Any]:
    """Every weight matrix of a port GPT's parameters (name -> tensor, the
    ``state_dict`` names) as a :class:`QuantizedArray`; norms, biases and
    leaves under ``min_size`` elements stay as they are. ``n_heads`` splits
    ``out_proj``'s input as flax's kernel does. Raises on a tree that is
    already quantized."""
    out: dict[str, Any] = {}
    for name, a in params.items():
        if isinstance(a, QuantizedArray):
            raise ValueError("quantize_tree: tree is already quantized")
        if (a.ndim < 2 or not a.is_floating_point() or a.numel() < min_size
                or name.endswith("bias")):
            out[name] = a
        else:
            out[name] = _quantize_leaf(name, a, n_heads)
    return out


def dequantize_tree(params: dict[str, Any]) -> dict[str, Any]:
    """A quantized tree back to plain tensors (testing/export)."""
    return {k: a.dequantize() if isinstance(a, QuantizedArray) else a for k, a in params.items()}


def quant_stats(params: dict[str, Any]) -> dict[str, int | float]:
    """Byte accounting for a (possibly) quantized tree. ``bytes_dense`` is
    the same tree with every quantized leaf back in its original dtype."""
    n_q = params_q = params_total = bytes_actual = bytes_dense = 0
    for a in params.values():
        params_total += a.numel()
        dense = a.numel() * torch.empty((), dtype=a.dtype).element_size()
        bytes_dense += dense
        if isinstance(a, QuantizedArray):
            n_q += 1
            params_q += a.numel()
            bytes_actual += a.nbytes
        else:
            bytes_actual += dense
    return {
        "quantized_leaves": n_q,
        "quantized_params": params_q,
        "total_params": params_total,
        "bytes": bytes_actual,
        "bytes_dense": bytes_dense,
        "compression": (bytes_dense / bytes_actual) if bytes_actual else 1.0,
    }


def model_tree(model: nn.Module) -> dict[str, Any]:
    """A model's parameters by ``state_dict`` name, with its quantized
    leaves in place of the parameters they replaced."""
    tree: dict[str, Any] = {}
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for attr, p in module.named_parameters(recurse=False):
            tree[prefix + attr] = p.detach()
        for attr, value in vars(module).items():
            if isinstance(value, QuantizedArray):
                tree[prefix + attr] = value
    return tree


def _install(model: nn.Module, name: str, value: Any) -> None:
    mod_name, _, attr = name.rpartition(".")
    module = model.get_submodule(mod_name)
    if isinstance(value, QuantizedArray):
        del module._parameters[attr]
        object.__setattr__(module, attr, value)
    else:
        delattr(module, attr)
        module.register_parameter(attr, nn.Parameter(value, requires_grad=False))


def quantize_model(model: nn.Module, *, min_size: int = 4096) -> dict[str, int | float]:
    """Quantize a GPT's weights in place (:func:`quantize_tree` over its
    parameters) and return :func:`quant_stats` of the result. Raises if
    the model is already quantized."""
    tree = quantize_tree(model_tree(model), n_heads=model.n_heads, min_size=min_size)
    for name, leaf in tree.items():
        if isinstance(leaf, QuantizedArray):
            _install(model, name, leaf)
    return quant_stats(tree)


def dequantize_model(model: nn.Module) -> nn.Module:
    """Restore a quantized model's parameters from their codes, in place."""
    for name, leaf in model_tree(model).items():
        if isinstance(leaf, QuantizedArray):
            _install(model, name, leaf.dequantize())
    return model


def dequantized(w: Any) -> torch.Tensor:
    """``w`` as a tensor: a :class:`QuantizedArray` dequantized to its
    original dtype, a tensor as it is."""
    return w.dequantize() if isinstance(w, QuantizedArray) else w


__all__ = [
    "QuantizedArray",
    "dequantize_model",
    "dequantize_tree",
    "dequantized",
    "model_tree",
    "quant_stats",
    "quantize_array",
    "quantize_model",
    "quantize_tree",
]
