"""int8/fp8 quantization (port of ``llmtrain_tpu/ops/quant.py``): weight-only
int8 for serving, and the quantized training matmuls.

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
resident.

**Training** (``model.extra.matmul_precision``): :func:`quant_dot_general`
gives the projections of the model families the linear to use, and
:class:`QuantLinear` is the standalone ``nn.Linear`` with it. Modes:

* ``int8`` — the weight quantize-dequantized per output channel over its
  contracting axis at each step's value (:func:`fake_quant`);
  activations stay in the compute dtype;
* ``int8_act`` — the activations too, per row over their contracting
  axis;
* ``fp8`` — both operands scaled by their per-tensor amax onto e4m3's
  range (448), cast to ``float8_e4m3fn``, multiplied with f32
  accumulation and rescaled (:func:`fp8_bmm`: ``torch._scaled_mm`` on the
  card, the plain product of the e4m3 values in f32 elsewhere). Where the
  device cannot run an fp8 product (:func:`fp8_supported`),
  :func:`resolve_matmul_precision` falls back to ``f32`` with a one-time
  warning, JAX's config contract;
* ``f32`` — no change: :func:`quant_dot_general` returns None and the
  callers keep ``F.linear``, bit for bit the build without the knob.

Gradients are straight-through: :func:`fake_quant`'s backward is the
identity, and the fp8 product's backward is the exact product of the
saved full-precision operands, so master weights, the optimizer, ZeRO and
checkpoints never see codes.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger("llmtrain")

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


# ==========================================================================
# Training path: quantized matmuls with straight-through gradients.
# ==========================================================================

#: Accepted ``model.extra.matmul_precision`` values (``int8_act``: the
#: activations-too variant of ``int8``).
MATMUL_PRECISIONS = ("f32", "int8", "int8_act", "fp8")

# float8_e4m3fn's largest finite value: each operand's per-tensor scale
# maps its amax onto it, so the cast never overflows.
_E4M3_MAX = 448.0
# ``torch._scaled_mm`` takes dims that are multiples of 16 (the operands
# are zero-padded up to them; zero rows and columns add nothing).
_SCALED_MM_ALIGN = 16


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@functools.lru_cache(maxsize=None)
def _fp8_probe(device_type: str) -> bool:
    try:
        dev = torch.device(device_type)
        a = torch.ones((16, 16), device=dev).to(torch.float8_e4m3fn)
        if dev.type == "cuda":
            one = torch.ones((), device=dev)
            out = torch._scaled_mm(a, a.t(), scale_a=one, scale_b=one,
                                   out_dtype=torch.float32, use_fast_accum=False)
            out = out[0] if isinstance(out, tuple) else out
        else:
            out = a.float() @ a.float()
        return bool(out[0, 0].item() == 16.0)
    except Exception:  # noqa: BLE001 — any rejection means "no"
        return False


def fp8_supported(device: torch.device | str | None = None) -> bool:
    """True when ``device`` (default: the card if there is one, else the
    CPU) runs an end-to-end float8_e4m3fn product: probed once per process
    and device type with a tiny product (a dtype that exists is not
    enough: a card before sm_89 has no fp8 tensor cores)."""
    dev = _default_device() if device is None else torch.device(device)
    return _fp8_probe(dev.type)


_FALLBACK_WARNED: set[str] = set()


def _check_mode(mode: str) -> None:
    if mode not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision {mode!r} unknown; expected one of {list(MATMUL_PRECISIONS)}"
        )


def resolve_matmul_precision(mode: str, device: torch.device | str | None = None) -> str:
    """Validate a ``matmul_precision`` value and resolve it for ``device``:
    unknown values raise (config time, like ``loss_impl``); ``fp8`` where
    the device cannot run an fp8 product becomes ``f32`` with a one-time
    warning (the run proceeds, the precision claim does not)."""
    _check_mode(mode)
    if mode == "fp8" and not fp8_supported(device):
        if "fp8" not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add("fp8")
            logger.warning(
                "matmul_precision=fp8 requested but this device cannot run "
                "float8_e4m3fn matmuls; falling back to f32"
            )
        return "f32"
    return mode


class _FakeQuant(torch.autograd.Function):
    """int8 quantize-dequantize forward, identity backward."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, reduce_axes: tuple[int, ...]) -> torch.Tensor:
        return quantize_array(w, reduce_axes=reduce_axes).dequantize()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def fake_quant(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> torch.Tensor:
    """``w`` quantized to symmetric per-channel int8 over ``reduce_axes``
    (:func:`quantize_array`) and dequantized to its dtype, with a
    straight-through gradient: the backward is the identity, so the
    gradient reaches the full-precision master weight untouched."""
    return _FakeQuant.apply(w, tuple(a % w.ndim for a in reduce_axes))


def _fp8_cast(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x8, scale): ``x`` divided in f32 by its per-tensor scale
    ``max(amax, 1e-30) / 448`` (an f32 0-dim tensor on ``x``'s device, no
    host read) and cast to float8_e4m3fn, JAX ``_fp8_dot_impl``'s
    arithmetic. The amax comes from ``aminmax`` of ``x`` itself (the
    largest magnitude is exact in any float dtype), with no f32 or
    ``abs`` copy."""
    lo, hi = torch.aminmax(x)
    scale = torch.clamp_min(torch.maximum(-lo, hi).float(), 1e-30) / _E4M3_MAX
    return x.to(torch.float32, copy=True).div_(scale).to(torch.float8_e4m3fn), scale


def _fp8_operands(a: torch.Tensor, b: torch.Tensor):
    """(a8, b8, sa, sb): both operands through :func:`_fp8_cast`."""
    a8, sa = _fp8_cast(a)
    b8, sb = _fp8_cast(b)
    return a8, b8, sa, sb


def fp8_bmm_plain(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`fp8_bmm`: the e4m3 operands multiplied
    as f32 (every product of two e4m3 values is exact in f32), rescaled by
    ``sa * sb`` and rounded once to ``out_dtype``; (E, M, N)."""
    a8, b8, sa, sb = _fp8_operands(a, b)
    return (torch.bmm(a8.float(), b8.float()) * (sa * sb)).to(out_dtype)


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def _fp8_bmm_scaled_mm(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`fp8_bmm` on the card: one ``torch._scaled_mm`` per batch
    entry (f32 accumulation, ``use_fast_accum=False``), the scales applied
    and the one rounding to ``out_dtype`` made in its epilogue."""
    e, m, k = a.shape
    n = b.shape[-1]
    up = lambda x: -(-x // _SCALED_MM_ALIGN) * _SCALED_MM_ALIGN  # noqa: E731
    mp, kp, np_ = up(m), up(k), up(n)
    if (mp, kp, np_) != (m, k, n):
        # Zero rows/columns: the scales (amax) and the products are the
        # unpadded operands'.
        a, b = _pad_to(a, mp, kp), _pad_to(b, kp, np_)
    a8, b8, sa, sb = _fp8_operands(a, b)
    # The second operand column-major, as cuBLASLt's fp8 path takes it (a
    # linear's transposed weight already is: no copy then).
    b8 = b8.transpose(1, 2).contiguous().transpose(1, 2)
    outs = []
    for i in range(e):
        r = torch._scaled_mm(a8[i], b8[i], scale_a=sa, scale_b=sb, out_dtype=out_dtype,
                             use_fast_accum=False)
        outs.append(r[0] if isinstance(r, tuple) else r)
    out = outs[0][None] if e == 1 else torch.stack(outs)
    return out if (mp, np_) == (m, n) else out[:, :m, :n]


def fp8_bmm(a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(E, M, K) x (E, K, N) -> (E, M, N) in ``out_dtype`` through
    float8_e4m3fn with per-tensor scales over the whole of each operand:
    ``torch._scaled_mm`` for a tensor on the card, :func:`fp8_bmm_plain`
    elsewhere."""
    if a.is_cuda:
        return _fp8_bmm_scaled_mm(a, b, out_dtype)
    return fp8_bmm_plain(a, b, out_dtype)


class _Fp8Dot(torch.autograd.Function):
    """fp8 forward (:func:`fp8_bmm`, cast to the operands' dtype), exact
    backward: the products of the incoming gradient with the saved
    full-precision operands (JAX ``_fp8_dot``: differentiating through the
    casts would hand the backward fp8 operands)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return fp8_bmm(a, b, torch.promote_types(a.dtype, b.dtype))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(grad.to(a.dtype), b.to(a.dtype).transpose(1, 2))
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(b.dtype).transpose(1, 2), grad.to(b.dtype))
        return ga, gb


def fp8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, K) x (E, K, N) in fp8 with the exact backward (:class:`_Fp8Dot`)."""
    return _Fp8Dot.apply(a, b)


def quant_dot_general(mode: str) -> Callable[..., torch.Tensor] | None:
    """The linear ``(x, w, bias=None) -> x @ w.T + bias`` of ``mode`` (``w``
    an ``nn.Linear`` weight, (out, in)), or None for ``f32``, so callers
    keep ``F.linear`` and f32 stays bit-identical to a build without the
    knob. ``mode`` must already be resolved
    (:func:`resolve_matmul_precision`). JAX's contracting axes map to
    ``w``'s input axis and ``x``'s last: one weight scale per output unit,
    one activation scale per row."""
    _check_mode(mode)
    if mode == "f32":
        return None

    def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
        if mode == "fp8":
            out = fp8_dot(x.reshape(1, -1, x.shape[-1]), w.t().unsqueeze(0))
            out = out.reshape(*x.shape[:-1], w.shape[0])
            return out if bias is None else out + bias
        if mode == "int8_act":
            x = fake_quant(x, (x.ndim - 1,))
        return F.linear(x, fake_quant(w, (1,)), bias)

    return linear


def expert_matmul(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The MoE expert product ``ebcd,edf->ebcf`` in ``mode`` (JAX
    ``moe._expert_matmul``: batch axis e, contracting d; int8 scales per
    (expert, output unit) on the weight, per (e, b, c) row on the
    activations; fp8 per tensor over all the experts)."""
    _check_mode(mode)
    if mode == "fp8":
        e, bsz, cap, d = x.shape
        return fp8_dot(x.reshape(e, bsz * cap, d), w).reshape(e, bsz, cap, w.shape[-1])
    if mode != "f32":
        w = fake_quant(w, (1,))
        if mode == "int8_act":
            x = fake_quant(x, (3,))
    return torch.einsum("ebcd,edf->ebcf", x, w)


class QuantLinear(nn.Linear):
    """Drop-in ``nn.Linear`` with the quantized training matmul: the same
    parameters (``weight`` (out, in), ``bias``), f32 master weights,
    straight-through gradients, so its state dict loads into ``nn.Linear``
    and back (JAX ``QuantDense``). The model families route their own
    projections through :func:`quant_dot_general` instead."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 matmul_precision: str = "int8", **kwargs: Any) -> None:
        super().__init__(in_features, out_features, bias, **kwargs)
        self.matmul_precision = matmul_precision
        self._linear = quant_dot_general(matmul_precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._linear is None:
            return F.linear(x, self.weight, self.bias)
        return self._linear(x, self.weight, self.bias)


__all__ = [
    "MATMUL_PRECISIONS",
    "QuantLinear",
    "QuantizedArray",
    "dequantize_model",
    "dequantize_tree",
    "dequantized",
    "expert_matmul",
    "fake_quant",
    "fp8_bmm",
    "fp8_bmm_plain",
    "fp8_dot",
    "fp8_supported",
    "model_tree",
    "quant_stats",
    "quantize_array",
    "quantize_model",
    "quantize_tree",
    "quant_dot_general",
    "resolve_matmul_precision",
]
