"""Flash attention forward: the hand-written CUDA kernel, its plain version,
and the dispatch the GPT calls.

Counterpart of ``llmtrain_tpu/ops/flash_attention.py`` (dispatch) and of
``pallas_flash_attention_fwd`` in ``llmtrain_tpu/ops/pallas_attention.py``
(the TPU kernel). The kernel source is ``csrc/flash_attention_fwd.cu``;
it is compiled with ``nvcc`` for ``sm_90a`` on first use and called
through a plain C interface (ops/kernel_build.py).

* :func:`flash_attention_fwd` is the wrapper: a CUDA tensor goes to the
  kernel or raises, a CPU tensor goes to the plain version. There is no
  fallback from the kernel to the plain version.
* :func:`flash_attention_fwd_reference` is the plain PyTorch version with
  the kernel's arithmetic: f32 upcast, q scaled before the dot, the finite
  -1e30 for dead logits, segment-id masking. The CPU tests hold it against
  the Pallas kernel in interpret mode; ``chip_smoke.py`` holds the kernel
  against it on the card.
* :func:`flash_attention` is the model-facing dispatch (same signature as
  the JAX one).

This slice is forward only: a gradient through the CUDA path raises
``NotImplementedError`` (the backward kernels are ROADMAP.md's training
slice).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30  # finite, as in the Pallas kernel (pallas_attention.py:48)
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention_fwd.cu"


def _check_operands(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    causal: bool,
    window: int,
) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, D) / (B, T, Hkv, D)")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(
            f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}"
        )
    hkv = k.shape[2]
    if hkv < 1 or h % hkv != 0:
        raise ValueError(f"n_heads ({h}) must be a multiple of n_kv_heads ({hkv})")
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"mask must be (B, T) = {(b, t)}, got {tuple(mask.shape)}")
    if t < 1:
        raise ValueError("sequence length must be >= 1")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    return b, t, h, hkv, d


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(out, lse)``.

    ``out`` is (B, T, H, D) in q's dtype, ``lse`` (B*H, T) f32. K/V heads
    are grouped against query heads (query head h reads kv head
    h // (H/Hkv)). Rows with no live key carry finite values that the
    caller zeroes, exactly as with the kernel.
    """
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    g = h // hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, t, hkv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    pos = torch.arange(t, device=q.device)
    live = torch.ones((t, t), dtype=torch.bool, device=q.device)
    if causal:
        live &= pos[None, :] <= pos[:, None]
    if window:
        live &= (pos[:, None] - pos[None, :]) < window
    live = live[None, None, None]
    if mask is not None:
        seg = mask.to(torch.int32)
        seg_live = (seg != 0)[:, None, :] & (seg[:, :, None] == seg[:, None, :])
        live = live & seg_live[:, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    row_max = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - row_max)
    row_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = acc / row_sum.permute(0, 3, 1, 2, 4)
    lse = (row_max + torch.log(row_sum)).reshape(b, h, t).reshape(b * h, t)
    return out.reshape(b, t, h, d).to(q.dtype), lse


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    from .kernel_build import load_library

    lib = load_library(_SOURCE)
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    causal: bool,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    for name, x in (("k", k), ("v", v)) + ((("mask", mask),) if mask is not None else ()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    seg = None
    if mask is not None:
        seg = mask.to(torch.int32).contiguous()
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg.data_ptr() if seg is not None else None,
            out.data_ptr(), lse.data_ptr(),
            b, t, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window),
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        message = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {message}")
    flash_attention_fwd.launches += 1
    return out, lse


class _ForwardOnly(torch.autograd.Function):
    """Carries the kernel's forward; its backward is the training slice."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, window):  # noqa: ANN001 — autograd API
        return _launch_kernel(q, k, v, mask, causal, window)

    @staticmethod
    def backward(ctx, *grads):  # noqa: ANN001 — autograd API
        raise NotImplementedError(
            "flash attention backward on CUDA is not ported yet: the dq and "
            "dk/dv kernels are ROADMAP.md queue A's training slice"
        )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over (B, T, H, D) q: ``(out, lse)``.

    CUDA tensors launch the kernel (and add one to
    ``flash_attention_fwd.launches``); CPU tensors take the plain
    version; anything else raises.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, mask, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _ForwardOnly.apply(q, k, v, mask, causal, window)
    return _launch_kernel(q, k, v, mask, causal, window)


flash_attention_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention over (B, T, H, Dh) through the flash forward.

    ``k``/``v`` may be grouped-query narrow (B, T, Hkv, Dh).
    ``attention_mask`` (B, T) holds segment ids (nonzero = real token,
    equal ids = same document). ``window`` > 0 keeps each query's
    trailing ``window`` keys (requires ``causal``).
    """
    out, _ = flash_attention_fwd(q, k, v, attention_mask, causal=causal, window=window)
    return out


__all__ = [
    "NEG_INF",
    "SUPPORTED_HEAD_DIMS",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
]
