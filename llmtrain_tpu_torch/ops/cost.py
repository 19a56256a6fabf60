"""Closed-form cost of the hand-written kernels, and their ``meta`` path.

The cost count of a step (telemetry/profiling.py) runs the step on
``meta`` tensors under a dispatch mode that counts every aten op. The
kernels are ``torch.autograd.Function``s that call their extension
directly, so the mode never sees them: each kernel wrapper, given a
``meta`` tensor, instead reports its own work to :func:`record` — the
flops and the bytes of the formulas behind PERF.md's bounds (chip_smoke.py
``flash_bound``, ``bwd_bounds``, ``norm_bwd_bounds``, ``ce_bounds``): each
input read once, each output written once, and the products the kernel
does (a causal or windowed attention counts only its live (query, key)
pairs) — and returns empty ``meta`` outputs of the kernel's shapes. Nothing
launches, nothing is allocated, and no launch count moves.

A segment mask is data the count does not see: the attention kernels are
counted at their causal (or windowed) pairs.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterator

Recorder = Callable[[str, float, float], None]

_lock = threading.Lock()
_recorders: list[Recorder] = []


@contextmanager
def recording(recorder: Recorder) -> Iterator[None]:
    """Route :func:`record` to ``recorder`` (name, flops, bytes) for the
    duration. Process-wide, not per thread: autograd may run a backward on
    another thread than the one that started it."""
    with _lock:
        _recorders.append(recorder)
    try:
        yield
    finally:
        with _lock:
            _recorders.remove(recorder)


def record(name: str, flops: float, bytes_accessed: float) -> None:
    """One kernel call's closed-form cost, to the innermost recorder."""
    with _lock:
        recorder = _recorders[-1] if _recorders else None
    if recorder is not None:
        recorder(name, float(flops), float(bytes_accessed))


def _pairs(t: int, causal: bool, window: int) -> int:
    if window:
        return sum(min(i + 1, window) for i in range(t))
    return t * (t + 1) // 2 if causal else t * t


def flash_fwd_cost(b: int, t: int, h: int, hkv: int, d: int, elt: int, *,
                   causal: bool = True, window: int = 0) -> tuple[float, float]:
    """q, k, v in and O out in the operands' dtype, lse (f32) out;
    QKᵀ and PV, 2·D flop each per live pair."""
    moved = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt + 4 * b * h * t
    return 4 * d * _pairs(t, causal, window) * b * h, moved


def flash_bwd_costs(b: int, t: int, h: int, hkv: int, d: int, elt: int, *,
                    causal: bool = True, window: int = 0
                    ) -> tuple[tuple[float, float], tuple[float, float]]:
    """((dq flops, bytes), (dkdv flops, bytes)): each kernel reads q, k, v,
    dO, lse and delta once and writes its outputs once; dq does 3 products
    per live pair (S, dP, dQ), dk/dv 4 (S, dP, dV, dK), 2·D flop each."""
    pairs = b * h * _pairs(t, causal, window)
    reads = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt + 2 * 4 * b * h * t
    dq = (3 * 2 * d * pairs, reads + b * t * h * d * elt)
    dkdv = (4 * 2 * d * pairs, reads + 2 * b * t * hkv * d * elt)
    return dq, dkdv


# Elementwise work of the LayerNorm kernels, a flop per element per
# operation: forward add, mean, centre, square, variance sum, normalise,
# scale, shift; backward recomputes x̂, forms gy·scale, its two row sums,
# dx, and the dscale/dbias products and sums.
_NORM_FWD_FLOPS_PER_ELT = 8
_NORM_BWD_FLOPS_PER_ELT = 10


def norm_fwd_cost(n: int, d: int, elt: int, *, residual: bool) -> tuple[float, float]:
    """x in, y out, scale/bias (f32) in, mean/rstd (f32) out; with the
    residual one more (n, d) read and the sum s written."""
    moved = 2 * n * d * elt + 2 * d * 4 + 2 * n * 4
    if residual:
        moved += 2 * n * d * elt
    return (_NORM_FWD_FLOPS_PER_ELT + residual) * n * d, moved


def norm_bwd_cost(n: int, d: int, elt: int, *, gs: bool) -> tuple[float, float]:
    """s and dy in, dx out, scale, mean/rstd and dscale/dbias once; the gs
    flavour reads one more (n, d) tensor and adds it."""
    moved = 3 * n * d * elt + d * 4 + 2 * n * 4 + 2 * d * 4
    if gs:
        moved += n * d * elt
    return (_NORM_BWD_FLOPS_PER_ELT + gs) * n * d, moved


def ce_costs(n: int, d: int, v: int, elt: int) -> tuple[tuple[float, float], ...]:
    """((fwd), (dh), (dw)) as (flops, bytes). Each kernel reads h, W and the
    labels once; the forward writes lse and the label logit (f32) and does
    2·N·V·d flop; the backward kernels also read lse, g_lse and g, recompute
    the logits and contract them once more (4·N·V·d flop each); dh writes
    (N, d) in the operands' dtype, dW (V, d) f32."""
    reads = (n * d + v * d) * elt + 4 * n
    return ((2 * n * v * d, reads + 2 * 4 * n),
            (4 * n * v * d, reads + 3 * 4 * n + n * d * elt),
            (4 * n * v * d, reads + 3 * 4 * n + v * d * 4))


__all__ = [
    "ce_costs",
    "flash_bwd_costs",
    "flash_fwd_cost",
    "norm_bwd_cost",
    "norm_fwd_cost",
    "record",
    "recording",
]
