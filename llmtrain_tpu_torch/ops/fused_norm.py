"""Fused residual-add + LayerNorm: the hand-written kernels (forward in
Triton, backward in CUDA C++), their plain versions, and the autograd
functions the GPT calls.

Counterpart of ``llmtrain_tpu/ops/fused_norm.py``: the TPU kernels
``_run_forward`` (``_fwd_kernel``, pallas_call at :142) and
``_run_backward`` (``_bwd_kernel``, pallas_call at :168).

    s     = x (+ residual)                      (f32, stored in x's dtype)
    y     = (s - mean) * rstd * scale + bias    (two-pass f32 mean/var, eps 1e-6)
    xhat  = (s - mean) * rstd
    dxhat = dy * scale
    ds    = rstd * (dxhat - mean_d(dxhat) - xhat * mean_d(dxhat * xhat))
    dscale = sum_tokens(dy * xhat),  dbias = sum_tokens(dy)

With ``gs``, the cotangent of the returned sum (the residual stream), the
backward writes ``dx = (ds + gs)`` with the two roundings of
``(ds + gs).to(dtype)``, which JAX runs after its pallas_call.

The forward is a Triton kernel, one program per token row: a pass over
768 values with a row reduction, bound by bytes. The backward is CUDA
C++, ``csrc/fused_norm_bwd.cu``, compiled with ``nvcc`` for ``sm_90a`` on
first use and called through a plain C interface (ops/kernel_build.py):
a warp owns a row and reduces it with shuffles, a block of eight warps
owns a fixed run of rows, and the blocks' dscale/dbias partials are
summed in a fixed order (blocks within groups, then the groups) by the
last blocks to finish, in the same launch (the note at the head of the
source says why). :func:`_bwd_grid` picks that split on the host.

* :func:`fused_norm_fwd` / :func:`fused_norm_bwd` are the kernels'
  wrappers: CUDA tensors launch the kernel (counted in ``.launches``) or
  raise, CPU tensors take the plain versions
  :func:`fused_norm_fwd_reference` / :func:`fused_norm_bwd_reference`.
* :func:`fused_layer_norm` (returns y) and :func:`fused_add_layer_norm`
  (returns ``(y, s)``) are the JAX public functions, as
  ``torch.autograd.Function``s that save ``s``, ``mean`` and ``rstd``.

Divergence kept on purpose: JAX's ``resolve_fused_norm`` quietly falls
back to the unfused LayerNorm off the TPU. The port does not: on the card
it runs the kernels or raises, on the CPU it runs the plain versions.
Triton is imported, and the CUDA source built, inside the launching
functions only (the CPU tests import this module on a machine with
neither).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Any

import torch

from .cost import norm_bwd_cost, norm_fwd_cost, record

DEFAULT_EPS = 1e-6
_KERNELS: dict[str, Any] = {}
_KERNELS_LOCK = threading.Lock()
_BWD_SOURCE = "fused_norm_bwd.cu"
_BWD_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The backward's grid (csrc/fused_norm_bwd.cu): blocks of BWD_WARPS warps
# (the kernel's kWarps), at most BWD_CTAS_PER_SM blocks per SM, each owning
# at least BWD_MIN_CTA_ELEMENTS elements (32 rows at d = 768), so that a
# small input runs on few blocks; BWD_COUNTERS ticket counters per (device,
# stream), the kernel's kMaxCounters.
BWD_WARPS = 8
BWD_CTAS_PER_SM = 1
BWD_MIN_CTA_ELEMENTS = 32 * 768
BWD_COUNTERS = 64
_BWD_MAX_FAST_D = 1024
_BWD_STATE: dict[tuple[int | None, int], tuple[int, torch.Tensor]] = {}
_BWD_LOCK = threading.Lock()


def _check(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
           bias: torch.Tensor | None) -> tuple[int, int]:
    d = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x {tuple(x.shape)}")
    if scale.shape != (d,) or (bias is not None and bias.shape != (d,)):
        raise ValueError(f"scale/bias must be ({d},)")
    return x.numel() // d, d


def fused_norm_fwd_reference(
    x: torch.Tensor,
    residual: torch.Tensor | None,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(y, s, mean, rstd)``; y and
    s in x's dtype and shape, mean and rstd f32 of shape (tokens,)."""
    n, d = _check(x, residual, scale, bias)
    s32 = x.float().reshape(n, d)
    if residual is not None:
        s32 = s32 + residual.float().reshape(n, d)
    mean = s32.mean(dim=1)
    diff = s32 - mean[:, None]
    rstd = torch.rsqrt((diff * diff).mean(dim=1) + eps)
    y = diff * rstd[:, None] * scale.float() + bias.float()
    return (y.to(x.dtype).reshape(x.shape), s32.to(x.dtype).reshape(x.shape), mean, rstd)


def fused_norm_bwd_reference(
    s: torch.Tensor,
    scale: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    gy: torch.Tensor,
    gs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: ``(ds, dscale, dbias)``; ds
    in gy's dtype and shape, dscale/dbias f32 sums over all tokens. With
    ``gs`` (the cotangent of the returned sum) the first output is
    ``dx = (ds + gs)``, rounded as ``(ds + gs).to(gy.dtype)`` rounds it:
    ds to gy's dtype first, then the f32 sum."""
    n, d = _check(s, None, scale, None)
    sf = s.float().reshape(n, d)
    gyf = gy.float().reshape(n, d)
    xhat = (sf - mean[:, None]) * rstd[:, None]
    dxhat = gyf * scale.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    ds = (rstd[:, None] * (dxhat - m1 - xhat * m2)).to(gy.dtype)
    if gs is not None:
        ds = (ds.float() + gs.float().reshape(n, d)).to(gy.dtype)
    return ds.reshape(gy.shape), (gyf * xhat).sum(dim=0), gyf.sum(dim=0)


def _triton_kernels() -> dict[str, Any]:
    """The Triton forward kernel, defined (and Triton imported) on first
    use; Triton compiles it on its first launch."""
    with _KERNELS_LOCK:
        if _KERNELS:
            return _KERNELS
        import triton
        import triton.language as tl

        @triton.jit
        def ln_fwd(X, R, W, B, Y, S, MEAN, RSTD, n_cols, eps,
                   HAS_RES: tl.constexpr, BLOCK_D: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            m = cols < n_cols
            off = row * n_cols + cols
            s = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            if HAS_RES:
                s += tl.load(R + off, mask=m, other=0.0).to(tl.float32)
                tl.store(S + off, s.to(S.dtype.element_ty), mask=m)
            mean = tl.sum(s, axis=0) / n_cols
            diff = tl.where(m, s - mean, 0.0)
            var = tl.sum(diff * diff, axis=0) / n_cols
            rstd = tl.rsqrt(var + eps)
            w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
            b = tl.load(B + cols, mask=m, other=0.0).to(tl.float32)
            y = diff * rstd * w + b
            tl.store(Y + off, y.to(Y.dtype.element_ty), mask=m)
            tl.store(MEAN + row, mean)
            tl.store(RSTD + row, rstd)

        _KERNELS.update(ln_fwd=ln_fwd, next_power_of_2=triton.next_power_of_2)
        return _KERNELS


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(tensors: dict[str, torch.Tensor]) -> None:
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"fused norm kernels take float32 or bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused norm kernels need contiguous operands ({name})")


def _block_and_warps(d: int, kernels: dict[str, Any]) -> tuple[int, int]:
    block = kernels["next_power_of_2"](d)
    return block, min(max(block // 256, 1), 8)


def fused_norm_fwd(
    x: torch.Tensor,
    residual: torch.Tensor | None,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, s, mean, rstd)`` of (x + residual) over the last axis: the
    Triton forward kernel for CUDA tensors (one launch, counted in
    ``fused_norm_fwd.launches``), the plain version for CPU ones. Without
    a residual, ``s`` is ``x`` itself."""
    if x.device.type == "cpu":
        return fused_norm_fwd_reference(x, residual, scale, bias, eps)
    if x.device.type == "meta":  # the cost count (ops/cost.py)
        n, d = x.reshape(-1, x.shape[-1]).shape
        record("fused_norm_fwd", *norm_fwd_cost(n, d, x.element_size(),
                                                residual=residual is not None))
        stats = torch.empty(n, dtype=torch.float32, device=x.device)
        s = x if residual is None else torch.empty_like(x)
        return torch.empty_like(x), s, stats, torch.empty_like(stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused norm runs on cuda or cpu tensors, not {x.device}")
    n, d = _check(x, residual, scale, bias)
    operands = {"x": x, "scale": scale, "bias": bias}
    if residual is not None:
        operands["residual"] = residual
        if residual.dtype != x.dtype:
            raise TypeError(f"residual dtype {residual.dtype} != x dtype {x.dtype}")
    _check_cuda(operands)
    kernels = _triton_kernels()
    y = torch.empty_like(x)
    s = torch.empty_like(x) if residual is not None else x
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    block, warps = _block_and_warps(d, kernels)
    if n:
        with torch.cuda.device(x.device):
            kernels["ln_fwd"][(n,)](
                x, residual if residual is not None else x, scale, bias, y, s, mean, rstd,
                d, eps, HAS_RES=residual is not None, BLOCK_D=block, num_warps=warps,
            )
        fused_norm_fwd.launches += 1
    return y, s, mean, rstd


fused_norm_fwd.launches = 0


def _bwd_grid(n: int, d: int, sm_count: int) -> tuple[int, int, int]:
    """``(blocks, rows per block, group)`` of the backward kernel for n
    rows of width d: block c owns rows [c * rows, min(n, (c + 1) * rows)),
    and its warp w takes rows w, w + BWD_WARPS, ... of that run. At most
    BWD_CTAS_PER_SM blocks per SM, each with at least BWD_MIN_CTA_ELEMENTS
    elements, and every block owns at least one row. The blocks' partial
    sums are added in groups of ``group`` blocks (the square root of the
    grid, rounded up), then the group sums in group order. The order of
    every sum the kernel takes depends only on (n, d, sm_count)."""
    if n < 1 or d < 1 or sm_count < 1:
        raise ValueError(f"need n, d and the SM count >= 1, got {n}, {d}, {sm_count}")
    min_rows = max(BWD_WARPS, -(-BWD_MIN_CTA_ELEMENTS // d))
    ctas = max(1, min(sm_count * BWD_CTAS_PER_SM, -(-n // min_rows)))
    rows = -(-n // ctas)
    ctas = -(-n // rows)
    return ctas, rows, math.isqrt(ctas - 1) + 1


def _bwd_takes_register_path(d: int, dtype: torch.dtype, *tensors: torch.Tensor) -> bool:
    """The kernel's register path: rows of whole 16-byte vectors up to
    1024 wide, 16-byte aligned operands; anything else takes its general
    path (csrc/fused_norm_bwd.cu)."""
    per_vector = 16 // dtype.itemsize
    return (d % per_vector == 0 and d <= _BWD_MAX_FAST_D
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signatures declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    from .kernel_build import load_library

    lib = load_library(_BWD_SOURCE)
    if lib.fused_norm_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_norm_bwd.argtypes = [p] * 10 + [i] * 8 + [p]
        lib.fused_norm_bwd.restype = ctypes.c_int
        lib.fused_norm_bwd_error_string.argtypes = [i]
        lib.fused_norm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_state(device: torch.device, stream: int) -> tuple[int, torch.Tensor]:
    """The device's SM count and the zeroed ticket counters of (device,
    stream); the kernel leaves them zeroed after each launch."""
    key = (device.index, stream)
    state = _BWD_STATE.get(key)
    if state is None:
        with _BWD_LOCK:
            state = _BWD_STATE.get(key)
            if state is None:
                sm_count = torch.cuda.get_device_properties(device).multi_processor_count
                counters = torch.zeros(BWD_COUNTERS, dtype=torch.int32, device=device)
                state = _BWD_STATE[key] = (sm_count, counters)
    return state


def _launch_bwd(lib: Any, s: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, gy: torch.Tensor, gs: torch.Tensor | None,
                sm_count: int, counters: torch.Tensor, stream: int) -> tuple[torch.Tensor, ...]:
    """One launch of ``lib.fused_norm_bwd`` on checked operands:
    ``(ds or dx, dscale, dbias)``."""
    d = s.shape[-1]
    n = s.numel() // d
    ds = torch.empty_like(gy)
    ctas, rows, group = _bwd_grid(n, d, sm_count)
    operands = (s, gy, ds) if gs is None else (s, gy, gs, ds)
    general = not _bwd_takes_register_path(d, s.dtype, *operands)
    partials = ctas + -(-ctas // group) + (ctas * BWD_WARPS if general else 0)
    workspace = torch.empty(partials * 2 * d, dtype=torch.float32, device=s.device)
    sums = torch.empty(2 * d, dtype=torch.float32, device=s.device)
    rc = lib.fused_norm_bwd(
        s.data_ptr(), gy.data_ptr(), gs.data_ptr() if gs is not None else None, scale.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), ds.data_ptr(), workspace.data_ptr(),
        counters.data_ptr(), sums.data_ptr(), n, d, ctas, rows, group, BWD_WARPS, int(general),
        _BWD_DTYPE_CODES[s.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_norm_bwd launch failed: "
                           f"{lib.fused_norm_bwd_error_string(rc).decode()}")
    return ds, sums[:d], sums[d:]


def fused_norm_bwd(
    s: torch.Tensor,
    scale: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    gy: torch.Tensor,
    gs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ds, dscale, dbias)``, or ``(dx, dscale, dbias)`` with ``gs``: the
    CUDA backward kernel for CUDA tensors (one launch per call, counted in
    ``fused_norm_bwd.launches``), the plain version for CPU ones.
    dscale/dbias come back f32. s, gy and gs share one dtype (float32 or
    bfloat16); scale is taken in f32."""
    if s.device.type == "cpu":
        return fused_norm_bwd_reference(s, scale, mean, rstd, gy, gs)
    if s.device.type == "meta":  # the cost count (ops/cost.py)
        n, d = s.reshape(-1, s.shape[-1]).shape
        record("fused_norm_bwd", *norm_bwd_cost(n, d, s.element_size(), gs=gs is not None))
        sums = torch.empty(2 * d, dtype=torch.float32, device=s.device)
        return torch.empty_like(gy), sums[:d], sums[d:]
    if s.device.type != "cuda":
        raise ValueError(f"fused norm runs on cuda or cpu tensors, not {s.device}")
    n, d = _check(s, None, scale, None)
    operands = {"s": s, "scale": scale, "mean": mean, "rstd": rstd, "gy": gy}
    for name, t in (("gy", gy), ("gs", gs)):
        if t is None:
            continue
        operands[name] = t
        if t.shape != s.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != s {tuple(s.shape)}")
        if t.dtype != s.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != s dtype {s.dtype}")
    _check_cuda(operands)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise TypeError(f"{name} must be float32 ({n},), got {t.dtype} {tuple(t.shape)}")
    scale = scale.float()
    if n == 0:
        zeros = torch.zeros(2 * d, dtype=torch.float32, device=s.device)
        return torch.empty_like(gy), zeros[:d], zeros[d:]
    lib = _bwd_library()
    device = s.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fused_norm_bwd(s, scale, mean, rstd, gy, gs)
    stream = torch.cuda.current_stream().cuda_stream
    out = _launch_bwd(lib, s, scale, mean, rstd, gy, gs, *_bwd_state(device, stream), stream)
    fused_norm_bwd.launches += 1
    return out


fused_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):  # noqa: ANN001 — autograd API
        y, _, mean, rstd = fused_norm_fwd(x, None, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):  # noqa: ANN001 — autograd API
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = fused_norm_bwd(x, scale, mean, rstd, gy.contiguous())
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


class _FusedAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps):  # noqa: ANN001 — autograd API
        y, s, mean, rstd = fused_norm_fwd(x, residual, scale, bias, eps)
        ctx.save_for_backward(s, scale, mean, rstd)
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):  # noqa: ANN001 — autograd API
        s, scale, mean, rstd = ctx.saved_tensors
        # The returned sum is the residual stream: its gradient flows
        # straight through the add to both inputs, added to ds in the
        # kernel.
        dx, dscale, dbias = fused_norm_bwd(s, scale, mean, rstd, gy.contiguous(),
                                           gs.contiguous())
        return dx, dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def fused_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = DEFAULT_EPS
) -> torch.Tensor:
    """LayerNorm over the last axis, the no-residual flavour (``ln_1``)."""
    return _FusedLayerNorm.apply(x.contiguous(), scale, bias, eps)


def fused_add_layer_norm(
    x: torch.Tensor,
    residual: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(LN(x + residual), x + residual)`` in one pass: the
    post-attention pre-MLP site (``ln_2``); the second output is the
    updated residual stream."""
    return _FusedAddLayerNorm.apply(x.contiguous(), residual.contiguous(), scale, bias, eps)


__all__ = [
    "DEFAULT_EPS",
    "fused_add_layer_norm",
    "fused_layer_norm",
    "fused_norm_bwd",
    "fused_norm_bwd_reference",
    "fused_norm_fwd",
    "fused_norm_fwd_reference",
]
