"""Flash attention: the hand-written CUDA kernels, their plain versions,
and the differentiable dispatch the GPT calls.

Counterpart of ``llmtrain_tpu/ops/flash_attention.py`` (dispatch and
``jax.custom_vjp``) and of ``pallas_flash_attention_fwd`` /
``pallas_flash_attention_bwd`` in ``llmtrain_tpu/ops/pallas_attention.py``
(the TPU kernels). The kernel sources are ``csrc/flash_attention_fwd.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (dQ and dK/dV); each is
compiled with ``nvcc`` for ``sm_90a`` on first use and called through a
plain C interface (ops/kernel_build.py).

* :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq` and
  :func:`flash_attention_bwd_dkdv` are the kernels' wrappers: a CUDA
  tensor goes to the kernel or raises, a CPU tensor goes to the plain
  version. There is no fallback from a kernel to its plain version. Each
  counts its kernel launches in ``.launches``.
* :func:`flash_attention_fwd_reference` and
  :func:`flash_attention_bwd_reference` are the plain PyTorch versions
  with the kernels' arithmetic: f32 upcast, q scaled before the dot, the
  finite -1e30 for dead logits, segment-id masking, P recomputed from the
  saved logsumexp, delta = rowsum(dO * O) in f32, the query group summed
  into narrow dK/dV. The CPU tests hold them against the Pallas kernels in
  interpret mode; ``chip_smoke.py`` holds the kernels against them on the
  card.
* :func:`flash_attention` is the model-facing dispatch (the JAX
  signature): one ``torch.autograd.Function`` whose forward saves
  ``(q, k, v, out, lse)`` and whose backward runs
  :func:`flash_attention_bwd`, on either device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cost import flash_bwd_costs, flash_fwd_cost, record

NEG_INF = -1e30  # finite, as in the Pallas kernel (pallas_attention.py:48)
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"


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


def _live(t: int, mask: torch.Tensor | None, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    """(B or 1, 1, 1, T, T) bool: key s is live for query q."""
    pos = torch.arange(t, device=device)
    live = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        live &= pos[None, :] <= pos[:, None]
    if window:
        live &= (pos[:, None] - pos[None, :]) < window
    live = live[None, None, None]
    if mask is not None:
        seg = mask.to(torch.int32)
        seg_live = (seg != 0)[:, None, :] & (seg[:, :, None] == seg[:, None, :])
        live = live & seg_live[:, None, None]
    return live


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``(out, lse)``.

    ``out`` is (B, T, H, D) in q's dtype, ``lse`` (B*H, T) f32. K/V heads
    are grouped against query heads (query head h reads kv head
    h // (H/Hkv)). Rows with no live key carry finite values that the
    caller zeroes, exactly as with the kernel.
    """
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    g = h // hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, t, hkv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = torch.where(_live(t, mask, causal, window, q.device), s, torch.full_like(s, NEG_INF))
    row_max = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - row_max)
    row_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = acc / row_sum.permute(0, 3, 1, 2, 4)
    lse = (row_max + torch.log(row_sum)).reshape(b, h, t).reshape(b * h, t)
    return out.reshape(b, t, h, d).to(q.dtype), lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B*H, T): the backward's one
    reduction outside the kernels (pallas_attention.py:510)."""
    b, t, h, _ = out.shape
    delta = (dout.float() * out.float()).sum(dim=-1)  # (B, T, H)
    return delta.permute(0, 2, 1).reshape(b * h, t).contiguous()


def _bwd_reference_from_delta(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    mask: torch.Tensor | None,
    causal: bool,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).reshape(b, t, hkv, g, d)
    dof = dout.float().reshape(b, t, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, kf)
    s = torch.where(_live(t, mask, causal, window, q.device), s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.reshape(b, hkv, g, t, 1))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: ``(dq, dk, dv)``.

    The arithmetic of ``pallas_flash_attention_bwd``: q pre-scaled, dead
    logits at the finite -1e30, P = exp(S - lse), delta = rowsum(dO * O)
    in f32, dQ scaled once at the end, the G query heads of each kv head
    summed into (B, T, Hkv, D) dK/dV; dq in q's dtype, dk/dv in k's.
    """
    delta = attention_delta(out, dout)
    return _bwd_reference_from_delta(q, k, v, dout, lse, delta, mask, causal, window)


def _library(source: str) -> ctypes.CDLL:
    """A built kernel library with its C signatures declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    from .kernel_build import load_library

    lib = load_library(source)
    if source == _FWD_SOURCE and lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    if source == _BWD_SOURCE and lib.flash_attention_bwd_dq.argtypes is None:
        lib.flash_attention_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkdv.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_bwd_dkdv.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_operands(
    tensors: dict[str, torch.Tensor | None],
    mask: torch.Tensor | None,
    dtype: torch.dtype,
    d: int,
) -> torch.Tensor | None:
    """What every kernel wrapper checks before a launch; returns the int32
    segment ids (or None)."""
    device = tensors["q"].device
    for name, x in (*tensors.items(), ("mask", mask)):
        if x is not None and x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
    if dtype not in _DTYPE_CODES or any(
        x.dtype != dtype for n, x in tensors.items() if n in ("q", "k", "v", "dout")
    ):
        raise TypeError(
            "flash kernels take float32 or bfloat16 q/k/v/dout of one dtype, got "
            + "/".join(str(x.dtype) for n, x in tensors.items() if n in ("q", "k", "v", "dout"))
        )
    for name in ("lse", "delta"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    if not all(x.is_contiguous() for x in tensors.values()):
        raise ValueError("flash kernels need contiguous operands")
    if any(x.data_ptr() % 16 for n, x in tensors.items() if n in ("q", "k", "v", "dout")):
        raise ValueError("flash kernels need q/k/v/dout at 16-byte aligned addresses")
    return None if mask is None else mask.to(torch.int32).contiguous()


def _raise_on_error(lib: ctypes.CDLL, rc: int, error_fn: str, name: str) -> None:
    if rc != 0:
        message = getattr(lib, error_fn)(rc).decode()
        raise RuntimeError(f"{name} launch failed: {message}")


def _launch_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    causal: bool,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    seg = _check_kernel_operands({"q": q, "k": k, "v": v}, mask, q.dtype, d)
    lib = _library(_FWD_SOURCE)
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
    _raise_on_error(lib, rc, "flash_attention_error_string", "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _device_kind(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {q.device}")
    return q.device.type


def _count_fwd(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward on ``meta`` tensors (ops/cost.py): its closed-form cost
    recorded, empty outputs of the kernel's shapes."""
    b, t, h, d = q.shape
    record("flash_attention_fwd", *flash_fwd_cost(b, t, h, k.shape[2], d, q.element_size(),
                                                  causal=causal, window=window))
    return torch.empty_like(q), torch.empty((b * h, t), dtype=torch.float32, device=q.device)


def _count_bwd(name: str, q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> None:
    b, t, h, d = q.shape
    dq, dkdv = flash_bwd_costs(b, t, h, k.shape[2], d, q.element_size(), causal=causal,
                               window=window)
    record(name, *(dq if name == "flash_attention_bwd_dq" else dkdv))


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
    version; ``meta`` tensors are counted (ops/cost.py); anything else
    raises. Not differentiable by itself: :func:`flash_attention` carries
    the gradient.
    """
    kind = _device_kind(q)
    if kind == "cpu":
        return flash_attention_fwd_reference(q, k, v, mask, causal=causal, window=window)
    if kind == "meta":
        return _count_fwd(q, k, causal, window)
    return _launch_fwd(q, k, v, mask, causal, window)


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """dQ (B, T, H, D) in q's dtype from the saved ``lse`` and ``delta``
    (:func:`attention_delta`): the dq kernel for CUDA tensors (counted in
    ``flash_attention_bwd_dq.launches``), its plain version for CPU ones."""
    if _device_kind(q) == "cpu":
        return _bwd_reference_from_delta(q, k, v, dout, lse, delta, mask, causal, window)[0]
    if _device_kind(q) == "meta":
        _count_bwd("flash_attention_bwd_dq", q, k, causal, window)
        return torch.empty_like(q)
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    seg = _check_kernel_operands(
        {"q": q, "k": k, "v": v, "dout": dout, "lse": lse, "delta": delta}, mask, q.dtype, d
    )
    lib = _library(_BWD_SOURCE)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), seg.data_ptr() if seg is not None else None, dq.data_ptr(),
            b, t, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window),
            1.0 / math.sqrt(d), stream,
        )
    _raise_on_error(lib, rc, "flash_attention_bwd_error_string", "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkdv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), (B, T, Hkv, D) in k's dtype, summed over each kv head's
    query group: the dk/dv kernel for CUDA tensors (counted in
    ``flash_attention_bwd_dkdv.launches``), its plain version for CPU
    ones."""
    if _device_kind(q) == "cpu":
        return _bwd_reference_from_delta(q, k, v, dout, lse, delta, mask, causal, window)[1:]
    if _device_kind(q) == "meta":
        _count_bwd("flash_attention_bwd_dkdv", q, k, causal, window)
        return torch.empty_like(k), torch.empty_like(v)
    b, t, h, hkv, d = _check_operands(q, k, v, mask, causal, window)
    seg = _check_kernel_operands(
        {"q": q, "k": k, "v": v, "dout": dout, "lse": lse, "delta": delta}, mask, q.dtype, d
    )
    lib = _library(_BWD_SOURCE)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), seg.data_ptr() if seg is not None else None, dk.data_ptr(),
            dv.data_ptr(), b, t, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window),
            1.0 / math.sqrt(d), stream,
        )
    _raise_on_error(lib, rc, "flash_attention_bwd_error_string", "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward: ``(dq, dk, dv)`` for (B, T, H, D) q.

    delta = rowsum(dO * O) is one torch reduction, as JAX leaves it to XLA
    outside the Pallas calls; then the dq and dk/dv kernels on CUDA
    tensors, or the plain version on CPU tensors.
    """
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, dout, mask, causal=causal, window=window
        )
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkdv(
        q, k, v, dout, lse, delta, mask, causal=causal, window=window
    )
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_flash``/``_flash_masked`` of the JAX dispatch: the forward saves
    (q, k, v, out, lse) and the backward runs :func:`flash_attention_bwd`
    (kernels on the card, plain version on the CPU). The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, window):  # noqa: ANN001 — autograd API
        out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):  # noqa: ANN001 — autograd API
        q, k, v, out, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), mask, causal=ctx.causal, window=ctx.window
        )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention over (B, T, H, Dh), differentiable.

    ``k``/``v`` may be grouped-query narrow (B, T, Hkv, Dh).
    ``attention_mask`` (B, T) holds segment ids (nonzero = real token,
    equal ids = same document). ``window`` > 0 keeps each query's
    trailing ``window`` keys (requires ``causal``).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, attention_mask, causal, window)
    out, _ = flash_attention_fwd(q, k, v, attention_mask, causal=causal, window=window)
    return out


__all__ = [
    "NEG_INF",
    "SUPPORTED_HEAD_DIMS",
    "attention_delta",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkdv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
]
