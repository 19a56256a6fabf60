"""Fused residual-add + LayerNorm: hand-written Triton kernels (forward and
backward), their plain versions, and the autograd functions the GPT calls.

Counterpart of ``llmtrain_tpu/ops/fused_norm.py``: the TPU kernels
``_run_forward`` (``_fwd_kernel``, pallas_call at :142) and
``_run_backward`` (``_bwd_kernel``, pallas_call at :168).

    s     = x (+ residual)                      (f32, stored in x's dtype)
    y     = (s - mean) * rstd * scale + bias    (two-pass f32 mean/var, eps 1e-6)
    xhat  = (s - mean) * rstd
    dxhat = dy * scale
    ds    = rstd * (dxhat - mean_d(dxhat) - xhat * mean_d(dxhat * xhat))
    dscale = sum_tokens(dy * xhat),  dbias = sum_tokens(dy)

Why Triton and not CUDA C++: each kernel is one pass over rows of d (768)
values with a row reduction, the fused elementwise-plus-reduction work
Triton's block model serves as well as hand-written CUDA, and the port's
rules allow it for these two kernels. What bounds them is bytes: the
forward reads x (and the residual) once and writes y (and s) once, the
backward reads s and dy and writes dx, at 3.35 TB/s; the arithmetic is a
few operations per byte.

Design, and where it leaves the TPU's. The forward is one program per
token row (the TPU tiles 256 tokens per grid step because VMEM is large;
here a row of 768 values fits one program's registers and 32768 rows
keep every SM busy). The TPU backward sums dscale/dbias across the whole
token grid in one output block that every grid step revisits
(``_bwd_kernel``, :80-100); GPU programs run in no order, so each
backward program takes a fixed run of 32 rows, writes its partial sums
into an f32 (n_programs, 2, d) buffer, and a second launch reduces that
buffer over programs. No atomics, so the result is deterministic.

* :func:`fused_norm_fwd` / :func:`fused_norm_bwd` are the kernels'
  wrappers: CUDA tensors launch the Triton kernel (counted in
  ``.launches``; the backward's reduce launch in
  ``fused_norm_bwd.reduce_launches``) or raise, CPU tensors take the
  plain versions :func:`fused_norm_fwd_reference` /
  :func:`fused_norm_bwd_reference`.
* :func:`fused_layer_norm` (returns y) and :func:`fused_add_layer_norm`
  (returns ``(y, s)``) are the JAX public functions, as
  ``torch.autograd.Function``s that save ``s``, ``mean`` and ``rstd``.

Divergence kept on purpose: JAX's ``resolve_fused_norm`` quietly falls
back to the unfused LayerNorm off the TPU. The port does not: on the card
it runs the kernels or raises, on the CPU it runs the plain versions.
Triton is imported inside the launching functions only (the CPU tests
import this module on a machine without Triton).
"""

from __future__ import annotations

import threading
from typing import Any

import torch

DEFAULT_EPS = 1e-6
BWD_ROWS_PER_PROGRAM = 32
_KERNELS: dict[str, Any] = {}
_KERNELS_LOCK = threading.Lock()


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(ds, dscale, dbias)``;
    ds in gy's dtype and shape, dscale/dbias f32 sums over all tokens."""
    n, d = _check(s, None, scale, None)
    sf = s.float().reshape(n, d)
    gyf = gy.float().reshape(n, d)
    xhat = (sf - mean[:, None]) * rstd[:, None]
    dxhat = gyf * scale.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    ds = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return ds.to(gy.dtype).reshape(gy.shape), (gyf * xhat).sum(dim=0), gyf.sum(dim=0)


def _triton_kernels() -> dict[str, Any]:
    """The three Triton kernels, defined (and Triton imported) on first
    use; Triton compiles each on its first launch."""
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

        @triton.jit
        def ln_bwd(S, W, MEAN, RSTD, GY, DX, PART, n_rows, n_cols,
                   ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
            pid = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            m = cols < n_cols
            w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
            dw = tl.zeros([BLOCK_D], dtype=tl.float32)
            db = tl.zeros([BLOCK_D], dtype=tl.float32)
            for i in range(ROWS):
                row = pid * ROWS + i
                valid = row < n_rows
                rm = m & valid
                off = row * n_cols + cols
                s = tl.load(S + off, mask=rm, other=0.0).to(tl.float32)
                gy = tl.load(GY + off, mask=rm, other=0.0).to(tl.float32)
                mean = tl.load(MEAN + row, mask=valid, other=0.0)
                rstd = tl.load(RSTD + row, mask=valid, other=0.0)
                xhat = tl.where(rm, (s - mean) * rstd, 0.0)
                dxhat = gy * w
                m1 = tl.sum(dxhat, axis=0) / n_cols
                m2 = tl.sum(dxhat * xhat, axis=0) / n_cols
                dx = rstd * (dxhat - m1 - xhat * m2)
                tl.store(DX + off, dx.to(DX.dtype.element_ty), mask=rm)
                dw += gy * xhat
                db += gy
            base = pid * 2 * n_cols
            tl.store(PART + base + cols, dw, mask=m)
            tl.store(PART + base + n_cols + cols, db, mask=m)

        @triton.jit
        def sum_parts(PART, OUT, n_parts, width, BLOCK_P: tl.constexpr, BLOCK_W: tl.constexpr):
            pid = tl.program_id(0)
            cols = pid * BLOCK_W + tl.arange(0, BLOCK_W)
            cm = cols < width
            acc = tl.zeros([BLOCK_W], dtype=tl.float32)
            for p0 in range(0, n_parts, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                tile = tl.load(PART + rows[:, None].to(tl.int64) * width + cols[None, :],
                               mask=(rows < n_parts)[:, None] & cm[None, :], other=0.0)
                acc += tl.sum(tile, axis=0)
            tl.store(OUT + cols, acc, mask=cm)

        _KERNELS.update(ln_fwd=ln_fwd, ln_bwd=ln_bwd, sum_parts=sum_parts,
                        next_power_of_2=triton.next_power_of_2)
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


def fused_norm_bwd(
    s: torch.Tensor,
    scale: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    gy: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ds, dscale, dbias)``: the Triton backward kernel for CUDA tensors
    (``fused_norm_bwd.launches``) and its reduce of the per-program
    dscale/dbias partials (``fused_norm_bwd.reduce_launches``); the plain
    version for CPU ones. dscale/dbias come back f32."""
    if s.device.type == "cpu":
        return fused_norm_bwd_reference(s, scale, mean, rstd, gy)
    if s.device.type != "cuda":
        raise ValueError(f"fused norm runs on cuda or cpu tensors, not {s.device}")
    n, d = _check(s, None, scale, None)
    if gy.shape != s.shape:
        raise ValueError(f"gy shape {tuple(gy.shape)} != s {tuple(s.shape)}")
    _check_cuda({"s": s, "scale": scale, "mean": mean, "rstd": rstd, "gy": gy})
    kernels = _triton_kernels()
    ds = torch.empty_like(gy)
    n_parts = max(1, -(-n // BWD_ROWS_PER_PROGRAM))
    parts = torch.empty((n_parts, 2, d), dtype=torch.float32, device=s.device)
    sums = torch.empty(2 * d, dtype=torch.float32, device=s.device)
    block, warps = _block_and_warps(d, kernels)
    width = 2 * d
    with torch.cuda.device(s.device):
        kernels["ln_bwd"][(n_parts,)](
            s, scale, mean, rstd, gy, ds, parts, n, d,
            ROWS=BWD_ROWS_PER_PROGRAM, BLOCK_D=block, num_warps=warps,
        )
        fused_norm_bwd.launches += 1
        block_w = 64
        kernels["sum_parts"][(-(-width // block_w),)](
            parts, sums, n_parts, width, BLOCK_P=64, BLOCK_W=block_w, num_warps=4,
        )
        fused_norm_bwd.reduce_launches += 1
    return ds, sums[:d], sums[d:]


fused_norm_bwd.launches = 0
fused_norm_bwd.reduce_launches = 0


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
        ds, dscale, dbias = fused_norm_bwd(s, scale, mean, rstd, gy.contiguous())
        # The returned sum is the residual stream: its gradient flows
        # straight through the add to both inputs.
        dx = (ds + gs).to(gy.dtype)
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
    "BWD_ROWS_PER_PROGRAM",
    "DEFAULT_EPS",
    "fused_add_layer_norm",
    "fused_layer_norm",
    "fused_norm_bwd",
    "fused_norm_bwd_reference",
    "fused_norm_fwd",
    "fused_norm_fwd_reference",
]
