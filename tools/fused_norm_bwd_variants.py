#!/usr/bin/env python3
"""Time the fused LayerNorm backward on one H100: the earlier Triton
version against the CUDA kernel and its variants.

Run from the root of a checkout on a machine with the card:

    python3 tools/fused_norm_bwd_variants.py

At chip_smoke's training shape, (32768, 768) bf16, it times each version
three ways in one process:

* event: CUDA events around 100 back-to-back calls after warm-up, as
  chip_smoke's ``_time_ms`` does;
* device: torch.profiler over 50 calls, the sum of the CUDA durations of
  the kernels the calls launched, over 50 (chip_smoke's ``_device_ms``);
* host: ``time.perf_counter`` around 200 calls after warm-up, with no
  synchronise inside (the enqueue rate).

The earlier Triton backward (``ln_bwd``, one program per 32 rows writing
f32 partials, then ``sum_parts`` reducing them in a second launch) is
copied here and is on no path of the package. It is timed without the
residual's gradient and with it, where ``(ds + gs).to(dtype)`` follows
it in a third launch as ``_FusedAddLayerNorm.backward`` had it.

The CUDA kernel (``llmtrain_tpu_torch/csrc/fused_norm_bwd.cu``) is timed
through the package's wrapper and, with the variants, straight through
``_launch_bwd``: copies of the source changed by text substitution under
``build/norm_variants/``, built with one nvcc each, all started together.
The variants: 2, 3 and 6 stages in each warp's ring instead of 4 (1, 2
and 5 rows in flight); two blocks per SM (registers capped at 128, half
the shared memory); four warps a block at two blocks per SM; sixteen
warps a block; rows dealt to the blocks in turn instead of in runs; the
partials added by one block in one level; and, for timing only (their
results are wrong), the kernel without its grid sum, without its stores,
with loads alone, and with each block writing the device clock
(``%globaltimer``) at its start and after its rows in place of dscale,
printed as the spread of the blocks' end times. Per variant it prints
ptxas's registers and spills of the bf16 d = 768 instance and the error
against the plain version. The versions run in turns, the old and the
kept ones first and last.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROWS_PER_PROGRAM = 32
# name: (substitutions in fused_norm_bwd.cu, warps a block, blocks per SM)
LOADS_ONLY = ("refilled\n\n    float a1 = 0.0f, a2 = 0.0f;\n",
              "refilled\n    if (vs[0].x == 0x7f7f7f7fu && vg[0].y == vr[0].z) "
              "acc_b[0][0] += 1.0f;\n"
              "    continue;\n    float a1 = 0.0f, a2 = 0.0f;\n")
# Timing only: each block writes the device clock at its start and at the
# end of its rows into dscale's place, and stops there.
TIMELINE = "block timeline (timing only)"
HALF_SMEM = ("constexpr int kSmemBudget = 226 * 1024;", "constexpr int kSmemBudget = 113 * 1024;")
VARIANTS = {
    "as is": ([], 8, 1),
    "2 stages (1 row in flight)": ([("constexpr int kMaxStages = 4;",
                                     "constexpr int kMaxStages = 2;")], 8, 1),
    "3 stages": ([("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;")], 8, 1),
    "6 stages": ([("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")], 8, 1),
    "2 blocks per SM": ([("constexpr int kMinCtas = 1;", "constexpr int kMinCtas = 2;"),
                         HALF_SMEM], 8, 2),
    "4 warps, 2 blocks per SM": ([("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
                                  ("constexpr int kMinCtas = 1;", "constexpr int kMinCtas = 2;"),
                                  HALF_SMEM], 4, 2),
    "16 warps a block": ([("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")], 16, 1),
    "rows interleaved across blocks": ([(
        "  const int first = cta * a.rows_per_cta + warp, stride = kWarps;\n"
        "  const int rows = first < row_end ? (row_end - first + stride - 1) / stride : 0;",
        "  const int first = cta + warp * (int)gridDim.x, stride = kWarps * (int)gridDim.x;\n"
        "  const int rows = first < a.n ? (a.n - 1 - first) / stride + 1 : 0;")], 8, 1),
    "no grid sum (timing only)": ([("  if (!last) return;", "  return;")], 8, 1),
    "no stores (timing only)": ([("      reinterpret_cast<uint4*>(out)[v] = Vec<T>::pack(o);",
                                  "      if (o[0] == 1e30f) reinterpret_cast<uint4*>(out)[v] = "
                                  "Vec<T>::pack(o);")], 8, 1),
    "loads only (timing only)": ([LOADS_ONLY], 8, 1),
    TIMELINE: ([
        ("  const bool with_gs = a.gs != nullptr;\n\n  float scale[J][kN]",
         "  const bool with_gs = a.gs != nullptr;\n  unsigned long long t_start;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n\n"
         "  float scale[J][kN]"),
        ("  __syncthreads();\n\n  // The CTA's partial:",
         "  __syncthreads();\n  if (threadIdx.x == 0) {\n    unsigned long long t_end;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
         "    reinterpret_cast<unsigned long long*>(a.sums)[2 * blockIdx.x] = t_start;\n"
         "    reinterpret_cast<unsigned long long*>(a.sums)[2 * blockIdx.x + 1] = t_end;\n"
         "  }\n  return;\n\n  // The CTA's partial:"),
    ], 8, 1),
}
# A grid variant of the kept kernel: one group, so the last block adds all
# partials.
ONE_LEVEL = "one-level sum (last block adds all partials)"
# Fragment of the mangled name of the bf16 instance that d = 768 runs.
TAG = "fused_norm_bwd_kernelI13__nv_bfloat16Li3E"


def triton_backward():
    """The earlier Triton backward, as it was in ops/fused_norm.py: returns
    ``bwd(s, scale, mean, rstd, gy) -> (ds, dscale, dbias)``."""
    import torch
    import triton
    import triton.language as tl

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

    def bwd(s, scale, mean, rstd, gy):
        n, d = s.shape
        ds = torch.empty_like(gy)
        n_parts = max(1, -(-n // ROWS_PER_PROGRAM))
        parts = torch.empty((n_parts, 2, d), dtype=torch.float32, device=s.device)
        sums = torch.empty(2 * d, dtype=torch.float32, device=s.device)
        block = triton.next_power_of_2(d)
        ln_bwd[(n_parts,)](s, scale, mean, rstd, gy, ds, parts, n, d,
                           ROWS=ROWS_PER_PROGRAM, BLOCK_D=block,
                           num_warps=min(max(block // 256, 1), 8))
        sum_parts[(-(-2 * d // 64),)](parts, sums, n_parts, 2 * d, BLOCK_P=64, BLOCK_W=64,
                                      num_warps=4)
        return ds, sums[:d], sums[d:]

    return bwd


def three_ways(torch, fn, iters_host: int = 200) -> dict:
    """Event, device and host milliseconds per call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    event_ms = cs._time_ms(torch, fn)
    device_ms = cs._device_ms(torch, fn)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    names = ", ".join(f"{e.key[:40]} x{e.count}" for e in prof.key_averages()
                      if e.device_type.name == "CUDA")
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters_host):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters_host
    torch.cuda.synchronize()
    return dict(event_ms=event_ms, device_ms=device_ms, host_ms=host_ms, kernels=names)


def build_variants() -> dict:
    """name -> (loaded library, warps, blocks per SM), after printing the
    ptxas report of each variant's bf16 d = 768 instance."""
    import chip_smoke as cs
    from llmtrain_tpu_torch.ops.kernel_build import NVCC_FLAGS, find_nvcc

    csrc = ROOT / "llmtrain_tpu_torch" / "csrc"
    source = (csrc / "fused_norm_bwd.cu").read_text()
    out = ROOT / "build" / "norm_variants"
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for i, (name, (subs, _, _)) in enumerate(VARIANTS.items()):
        d = out / str(i)
        d.mkdir(parents=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in fused_norm_bwd.cu")
            text = text.replace(old, new)
        (d / "kernel.cu").write_text(text)
        jobs[name] = (d, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [r for m, r in cs.ptxas_resources(log).items() if TAG in m]
        print(f"[ptxas] {name}: bf16 d=768 instance: {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.fused_norm_bwd.argtypes = [p] * 10 + [i32] * 8 + [p]
        lib.fused_norm_bwd.restype = i32
        lib.fused_norm_bwd_error_string.argtypes = [i32]
        lib.fused_norm_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, *VARIANTS[name][1:])
    return libs


def report(name: str, t: dict, bound_ms: float, smi: str, extra: str = "") -> None:
    print(f"[variant] {name:34s} event {t['event_ms']:.4f} ms  device {t['device_ms']:.4f} ms  "
          f"host {t['host_ms']:.4f} ms  ({bound_ms / t['event_ms']:.1%} of the {bound_ms:.4f} ms "
          f"bound by event, {bound_ms / t['device_ms']:.1%} by device){extra}  kernels: "
          f"{t['kernels']}  on {smi}", flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from llmtrain_tpu_torch.ops import fused_norm as fn

    if not torch.cuda.is_available():
        print("fused_norm_bwd_variants: needs a GPU", file=sys.stderr)
        return 1
    libs = build_variants()
    smi = cs.phase_device(torch)
    n, d = cs.LN_TOKENS, cs.LN_DIM
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    bias = torch.zeros(d, device="cuda")
    gy = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    gs = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    _, s, mean, rstd = fn.fused_norm_fwd(x, None, scale, bias)
    (_, bound), (_, bound_gs) = cs.norm_bwd_bounds(n, d, 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    ref = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy)
    ref_gs = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy, gs)

    def err(got, want) -> float:
        return max(cs._rel_err(torch, a, b) for a, b in zip(got, want))

    old = triton_backward()
    calls, calls_gs = {}, {}
    calls["Triton ln_bwd + sum_parts"] = lambda: old(s, scale, mean, rstd, gy)
    calls_gs["Triton + (ds + gs).to(dtype)"] = \
        lambda: ((old(s, scale, mean, rstd, gy)[0] + gs).to(gy.dtype),)
    calls["CUDA, through fused_norm_bwd"] = lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy)
    calls_gs["CUDA with gs, through fused_norm_bwd"] = \
        lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs)
    grids = {}
    grid = fn._bwd_grid
    libs[ONE_LEVEL] = libs["as is"]
    for name, (lib, warps, per_sm) in libs.items():
        if name == TIMELINE:
            continue
        counter = torch.zeros(fn.BWD_COUNTERS, dtype=torch.int32, device="cuda")
        grids[name] = mock.patch.multiple(fn, BWD_WARPS=warps, BWD_CTAS_PER_SM=per_sm)
        if name == ONE_LEVEL:
            grids[name] = mock.patch.object(
                fn, "_bwd_grid", lambda n, d, sm: grid(n, d, sm)[:2] + (grid(n, d, sm)[0],))
        calls[name] = (lambda lib=lib, counter=counter: fn._launch_bwd(
            lib, s, scale, mean, rstd, gy, None, sms, counter, stream))
        calls_gs[name + ", gs"] = (lambda lib=lib, counter=counter: fn._launch_bwd(
            lib, s, scale, mean, rstd, gy, gs, sms, counter, stream))
        grids[name + ", gs"] = grids[name]
    lib = libs[TIMELINE][0]
    counter = torch.zeros(fn.BWD_COUNTERS, dtype=torch.int32, device="cuda")
    for _ in range(3):
        clock = fn._launch_bwd(lib, s, scale, mean, rstd, gy, None, sms, counter, stream)[1]
        torch.cuda.synchronize()
        ns = clock.view(torch.int64)[: 2 * sms].view(sms, 2).double()
        t0 = ns[:, 0].min()
        start, end = (ns[:, 0] - t0) / 1e3, (ns[:, 1] - t0) / 1e3
        q = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], dtype=torch.float64, device="cuda")
        print(f"[timeline] {sms} blocks, us after the first start: starts "
              f"{[round(x, 2) for x in start.quantile(q).tolist()]}, ends (quantiles 0, .1, "
              f".5, .9, 1) {[round(x, 2) for x in end.quantile(q).tolist()]}  on {smi}",
              flush=True)
    add = lambda: ((ref[0] + gs).to(gy.dtype),)  # noqa: E731
    add_bound = 3 * n * d * 2 / cs.H100_HBM_BYTES_PER_S * 1e3  # ds, gs in; dx out
    with torch.no_grad():
        report("(ds + gs).to(dtype) alone", three_ways(torch, add), add_bound, smi)
        for group, want, b in ((calls, ref, bound), (calls_gs, ref_gs, bound_gs)):
            names = list(group)
            for name in [*names, names[1], names[0]]:
                with grids.get(name, contextlib.nullcontext()):
                    got = group[name]()
                    torch.cuda.synchronize()
                    e = err(got, want[:len(got)])
                    report(name, three_ways(torch, group[name]), b, smi, f"  err {e:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
