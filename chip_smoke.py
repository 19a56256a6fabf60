#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (llmtrain_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Device: nvidia-smi name and power limit, torch/CUDA versions; TF32 off.
2. Build: the four CUDA sources (llmtrain_tpu_torch/csrc/flash_attention_fwd.cu,
   flash_attention_bwd.cu, fused_ce.cu and fused_norm_bwd.cu) with nvcc for
   sm_90a, one nvcc each, started together; register and spill report from
   ptxas, failing on a spill in any instance of fused_norm_bwd.cu; then
   cuobjdump -sass of the built libraries: the count of HMMA/HGMMA
   (tensor-core) instructions of the nine bf16 instances in
   TENSOR_CORE_KERNELS (flash_fwd_kernel, flash_bwd_dq_kernel and
   flash_bwd_dkdv_kernel at head dims 64 and 128, fused_ce_fwd_kernel,
   fused_ce_bwd_dh_kernel and fused_ce_bwd_dw_kernel)
   with their registers and spills, failing if any has no tensor-core
   instruction or spills.
3. Kernels vs their plain versions on the card, each case with a control
   broken on purpose that must land above the tolerance:
   a. flash forward at the serving and training shapes and around them
      (FLASH_CASES: f32 and bf16 GQA 12q/4kv, segment mask with padding,
      ragged T=200; bf16 T=1, T=65, sliding window, head_dim 128 alone,
      with GQA+segments and with a window). O on live query rows within
      2e-2 for bf16 inputs (one bf16 rounding of outputs of magnitude ~1)
      and 1e-4 for f32 (summation order only); lse (always f32) within
      1e-4 on every row whose query has a live key. Control: the plain
      version non-causal (window cases: window off; T=1: the other batch
      row's K/V) above the O limit. bf16 cases run twice: bit-identical;
   b. flash backward, dq and dk/dv kernels, at the training shape and the
      same cases (BWD_RTOL; control: delta left out, lse off by log 2;
      bf16 dq and dk/dv run twice: bit-identical);
   c. fused add+LayerNorm forward (Triton, first compile timed) and
      backward (CUDA) over NORM_CASES: the training path's 32768 x 768
      tokens, f32 and bf16, ragged counts, one row, d 384, d 100 and 2048,
      with and without the residual, the backward with and without the
      residual's gradient gs (LN_RTOL and friends; controls: bias left
      out, the mean(dxhat) term left out; bf16 backward run twice:
      bit-identical);
   d. fused lm-head CE forward, dh and dW at the CE training path's shape
      (32768, 768, 50257) bf16 with and without z-loss, f32, ragged N with
      V below one tile, d 64, a cotangent with zeros, and d 96 with N and V
      ragged against the bf16 dW kernel's tiles (CE_LOSS_RTOL, CE_DH_RTOL,
      CE_DW_RTOL; controls: the label logit read from column label + 1, the
      one-hot term left out of dlogit, the z-loss factor left out of g_lse;
      bf16 forward, dh and dW run twice: bit-identical).
4. Timing: CUDA events over back-to-back launches after warm-up, inputs
   warm in L2 as the ops that produce them leave them; each kernel, its
   plain version, and one PyTorch call as a yardstick never called by the
   port (SDPA forward/backward, F.layer_norm forward/backward; no single
   call computes the fused CE, so its yardstick is the composite F.linear
   -> F.cross_entropy forward/backward, reported as composite_ms);
   the bound from the shapes against the H100 SXM peaks; the LayerNorm
   kernels also by device time (torch.profiler). Forward at the
   serving shape (1, 512, 12, 64) and the training shape (64, 512, 12,
   64), backward at the training shape, LayerNorm at (32768, 768) bf16,
   fused CE at (32768, 768, 50257) bf16.
5. Model: the GPT of configs/presets/gpt_pycorpus_tpu.yaml at full width
   and depth (768 x 12 layers, 12 heads, block 512, byte vocab), seeded
   init, params cast to bf16 as serving does. One T=512 forward through
   the kernel against the same forward through the plain version: logits
   must be finite, (1, 512, 256), and within LOGITS_ATOL (the paths
   differ only in the bf16 rounding of each layer's attention output,
   compounded over 12 residual layers). Controls: the same comparison
   with attention broken on purpose (non-causal, output zeroed, only the
   last 64 keys) must exceed LOGITS_ATOL, or the limit could not tell a
   broken kernel from a right one and the phase fails.
6. Serve: the port's simple-mode HTTP server (make_server/ServerState, as
   `serve` builds it) on 127.0.0.1:0: greedy 32+32 and sampled 32+32
   (temperature 0.8, top_k 40, seed) on the KV-cache branch, no kernel
   launch; greedy 400+160, which exceeds block_size and gets the JAX
   server's 400; and a malformed body (400).
7. Generate: generation.generate(), which the `generate` CLI and the
   server call, greedy 400+160 (total 560 > 512): the re-forward branch,
   >= 12 x 160 kernel launches. Kernel launch counts are reset just
   before phase 6 and read just after phase 7: the serving path.
8. Profile: torch.profiler over one more greedy 400+160 generate() (warm
   from phase 7): wall time, device kernel time and busy share, kernel
   launches per token, top kernels by device time, and the flash
   kernels' device time and share. Measurement only; the profiler's own
   overhead inflates the wall.
9. Train: the port's `train` (in-process CLI) on gpt_pycorpus_tpu at full
   width, micro batch 64 x 512, into a temp root, with the cuts listed at
   TRAIN_STEPS: every logged loss finite and the last LOSS_DROP_MIN below
   the first; launch counts equal 12 forward, 12 dq and 12 dk/dv per step
   plus 12 forward per eval batch (counts reset just before the call and
   read just after: the training path); `train --resume` from the save
   at TRAIN_SAVE_EVERY ends within RESUME_ATOL of the uninterrupted run;
   `generate` answers a greedy request from the final checkpoint. Prints
   step ms, tokens/s, MFU and peak memory.
10. Fused-norm train: the same config with model.extra.fused_norm: true,
   same init, batches and learning rates, FUSED_STEPS steps: losses
   within FUSED_ATOL of the unfused run's at each step; LayerNorm
   launches 24 forward and 24 backward per step; median step time,
   tokens/s and peak memory.
11. Profile: torch.profiler over one warmed-up training step, of phase
   9's config and of phase 10's: wall, device kernel time and busy share,
   top kernels, the flash kernels' device time and share, and in the
   fused-norm step the LayerNorm kernels'. Measurement only.
12. CE train: the slice-3 configuration, phase 9's config with
   model.vocab_size 50257 and loss_impl unset, which must resolve to
   fused_ce, CE_STEPS steps with one eval and a save at the end: losses
   finite and falling by LOSS_DROP_MIN; launch counts (fused CE forward =
   steps + eval batches, dh = dW = steps, flash 12 per forward and per
   backward; counts reset just before the call and read just after);
   then the same run with loss_impl: dense: per-step losses within
   CE_ATOL, and peak memory at least the bf16 logits (3.07 GiB) above the
   fused run's.
13. Profile: one warmed-up CE training step, as phase 11.
14. Continuous serving of phase 9's final checkpoint at full width, the
   preset's serving defaults (8 slots, 16-token blocks, the default pool
   and buckets): (a) in-process `serve-bench --verify-parity`, greedy,
   CONT_REQUESTS requests of CONT_PROMPTS tokens + CONT_NEW_TOKENS on a
   Poisson open loop at CONT_RATE_RPS; (b) the same sampled (temperature
   0.8, top-k 40) with serving.prefix_cache, serving.prefill_chunk
   CONT_CHUNK and CONT_SHARED_PREFIX shared prefixes. Gates: exit 0,
   parity bitwise_identical, shapes within the bucket budget, every
   request completed, mean occupancy >= CONT_MIN_OCCUPANCY, the prefix
   cache hit. Then torch.profiler over CONT_PROFILE_STEPS decode steps at
   batch 8 (launches and device time per step; measurement only); then
   (c) `python -m llmtrain_tpu_torch serve --mode continuous` child
   processes on 127.0.0.1:0: 8 concurrent greedy requests all 200 with
   the simple-mode server's tokens, /healthz with the scheduler's stats,
   /metrics, POST /reload answered 200 while CONT_RELOAD_REQUESTS requests
   are in flight (they complete; the first with generate()'s tokens), and
   a server with
   serving.overload queue_cap 1 answering a burst with 429 +
   Retry-After. Kernel launch counts are reset before and read after:
   the paged path launches none of the eight kernels. Prints output
   tokens/s, TTFT and per-token p50/p99, occupancy, the prefix hit rate
   and peak memory.

Then it prints the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PATH_SHAPE = (1, 512, 12, 12, 64)  # B, T, H, Hkv, D at the serving path
TRAIN_SHAPE = (64, 512, 12, 12, 64)  # B, T, H, Hkv, D at the training path
LN_TOKENS, LN_DIM = 64 * 512, 768  # tokens and width at the training path
CUDA_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "fused_ce.cu",
                "fused_norm_bwd.cu")
ATOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
ATOL_LSE = 1e-4
LOGITS_ATOL = 0.1


def log(*parts: object) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    smi = nvidia_smi_line()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# The redesigned kernels' bf16 instances, which must run on the tensor
# cores: HMMA (mma.sync) or HGMMA (wgmma) in their SASS. Per source, each
# kernel with the int template arguments of its instances (head dims for
# the flash kernels; none for the fused CE forward, dh and dW).
TENSOR_CORE_KERNELS = {
    "flash_attention_fwd.cu": [("flash_fwd_kernel", (64,)), ("flash_fwd_kernel", (128,))],
    "flash_attention_bwd.cu": [
        ("flash_bwd_dq_kernel", (64,)), ("flash_bwd_dq_kernel", (128,)),
        ("flash_bwd_dkdv_kernel", (64,)), ("flash_bwd_dkdv_kernel", (128,)),
    ],
    "fused_ce.cu": [("fused_ce_fwd_kernel", ()), ("fused_ce_bwd_dh_kernel", ()),
                    ("fused_ce_bwd_dw_kernel", ())],
}


# Sources without tensor-core instructions whose every instance must
# still fit its registers: the build fails on a spill in any of them.
NO_SPILL_SOURCES = ("fused_norm_bwd.cu",)


def tensor_core_instance(kernel: str, dims: tuple[int, ...]) -> tuple[str, str]:
    """(label, mangled-name fragment) of ``kernel<dims..., __nv_bfloat16>``."""
    args = "".join(f"Li{d}E" for d in dims)
    label = ", ".join([*(str(d) for d in dims), "bf16"])
    return f"{kernel}<{label}>", f"{len(kernel)}{kernel}I{args}13__nv_bfloat16E"


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, else the copy in Triton's package."""
    import importlib.util
    import os
    import shutil

    from llmtrain_tpu_torch.ops.kernel_build import find_nvcc

    candidates = [Path(find_nvcc()).parent / "cuobjdump"]
    if shutil.which("cuobjdump"):
        candidates.append(Path(shutil.which("cuobjdump")))
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        for loc in spec.submodule_search_locations:
            candidates.append(Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(f"cuobjdump not found (looked at {[str(c) for c in candidates]})")


def sass_mma_counts(sass: str) -> dict[str, int]:
    """Mangled kernel name -> number of HMMA/HGMMA instructions in its
    SASS, from the text of ``cuobjdump -sass``."""
    import re

    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current and re.search(r"\bHG?MMA\b", line):
            counts[current] += 1
    return counts


def ptxas_resources(report: str) -> dict[str, str]:
    """Mangled kernel name -> its registers and spills from -Xptxas -v."""
    import re

    res, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            res[current] = []
        elif current and ("registers" in line or "spill" in line):
            res[current].append(line.split(":", 1)[-1].strip())
    return {name: "; ".join(parts) for name, parts in res.items()}


def phase_build() -> None:
    """One nvcc per CUDA source, all started together; then the SASS of
    the redesigned bf16 kernels must hold tensor-core instructions, and
    ptxas must report no spills for them or for any instance of the
    NO_SPILL_SOURCES."""
    import re

    from llmtrain_tpu_torch.ops.kernel_build import CSRC_DIR, build_libraries

    t0 = time.perf_counter()
    results = build_libraries([CSRC_DIR / name for name in CUDA_SOURCES])
    for r in results:
        log(f"[build] {r.source.name}: nvcc {r.seconds:.2f}s -> {r.library.name}")
        for name, resources in ptxas_resources(r.ptxas_report).items():
            log(f"[build]   {name}: {resources}")
    log(f"[build] all CUDA sources in {time.perf_counter() - t0:.2f}s wall")
    for r in results:
        if r.source.name in NO_SPILL_SOURCES:
            resources = ptxas_resources(r.ptxas_report)
            spilled = {n: x for n, x in resources.items()
                       if re.search(r"\b[1-9]\d* bytes spill", x)}
            log(f"[build] {r.source.name}: {len(resources)} instances (bf16 and f32), "
                f"{len(spilled)} spill")
            if not resources or spilled:
                raise RuntimeError(f"{r.source.name}: no ptxas report or spills: {spilled}")
        if r.source.name not in TENSOR_CORE_KERNELS:
            continue
        sass = subprocess.run([find_cuobjdump(), "-sass", str(r.library)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts = sass_mma_counts(sass)
        resources = ptxas_resources(r.ptxas_report)
        for kernel, dims in TENSOR_CORE_KERNELS[r.source.name]:
            label, tag = tensor_core_instance(kernel, dims)
            names = [n for n in counts if tag in n]
            n_mma = sum(counts[n] for n in names)
            regs = "; ".join(resources.get(n, "no ptxas line") for n in names)
            log(f"[build] {label}: {n_mma} HMMA/HGMMA instructions in SASS; ptxas: {regs}")
            if not names or n_mma == 0:
                raise RuntimeError(f"{label} has no tensor-core instruction")
            if re.search(r"\b[1-9]\d* bytes spill", regs):
                raise RuntimeError(f"{label} spills registers: {regs}")


def _qkv(torch, gen, b, t, h, hkv, d, dtype):
    def rnd(heads):
        return torch.randn(b, t, heads, d, device="cuda", generator=gen).to(dtype)

    return rnd(h), rnd(hkv), rnd(hkv)


def _segments(torch, b, t):
    """Two documents per row, and the last 37 tokens of row 0 padding."""
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    mask[:, t // 3 :] = 2  # a second document
    mask[0, max(0, t - 37) :] = 0  # padding
    return mask


# Cases of the flash check phases: (name, (B, T, H, Hkv, D), dtype,
# segment mask or not, window). The bf16 ones run the tensor-core
# instances of the forward and dk/dv kernels, the f32 ones the FMA
# instances; T=1 and T=65 put a ragged tail in the first and second key
# tile.
FLASH_CASES = [
    ("f32", (2, 384, 12, 12, 64), "float32", False, 0),
    ("gqa 12q/4kv", (2, 256, 12, 4, 64), "float32", False, 0),
    ("segments+padding", (2, 256, 12, 12, 64), "float32", True, 0),
    ("ragged T=200", (1, 200, 12, 12, 64), "float32", False, 0),
    ("window 128", (2, 512, 12, 12, 64), "bfloat16", False, 128),
    ("gqa 12q/4kv", (2, 256, 12, 4, 64), "bfloat16", False, 0),
    ("segments+padding", (2, 256, 12, 12, 64), "bfloat16", True, 0),
    ("ragged T=200", (1, 200, 12, 12, 64), "bfloat16", False, 0),
    ("T=1", (2, 1, 12, 12, 64), "bfloat16", False, 0),
    ("T=65", (2, 65, 12, 12, 64), "bfloat16", False, 0),
    ("head_dim 128", (2, 256, 8, 8, 128), "bfloat16", False, 0),
    ("d128 gqa+segments", (2, 200, 8, 2, 128), "bfloat16", True, 0),
    ("d128 window 100", (1, 300, 8, 8, 128), "bfloat16", False, 100),
]


def phase_kernel_checks(torch) -> float:
    """Kernel 1 (forward) against its plain version. Control per case: the
    plain version run non-causal (in the window cases, causal with the
    window off) must land above ATOL_O; at T = 1 every mask computes the
    same O = V, so that case's control reads the other batch row's K/V
    instead. bf16 cases also launch the kernel twice: O and lse must be
    bit-identical."""
    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("path shape", PATH_SHAPE, "bfloat16", False, 0),
        ("train shape", TRAIN_SHAPE, "bfloat16", False, 0),
        *FLASH_CASES,
    ]
    errors = {}
    for name, (b, t, h, hkv, d), dt_name, segmented, window in cases:
        dtype = getattr(torch, dt_name)
        q, k, v = _qkv(torch, gen, b, t, h, hkv, d, dtype)
        mask = _segments(torch, b, t) if segmented else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True, window=window)
        same = True
        if dtype == torch.bfloat16:
            out2, lse2 = flash_attention_fwd(q, k, v, mask, causal=True, window=window)
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, mask, causal=True, window=window)
        if t == 1:
            control = "k/v of the other batch row"
            broken = flash_attention_fwd_reference(q, k.flip(0), v.flip(0), mask, causal=True)[0]
        elif window:
            control = "window off"
            broken = flash_attention_fwd_reference(q, k, v, mask, causal=True)[0]
        else:
            control = "non-causal"
            broken = flash_attention_fwd_reference(q, k, v, mask, causal=False)[0]
        live = torch.ones(b, t, dtype=torch.bool, device="cuda") if mask is None else mask != 0
        o_err = (out.float() - ref_out.float()).abs()[live].max().item()
        ctrl = (out.float() - broken.float()).abs()[live].max().item()
        lse_err = (lse - ref_lse).view(b, h, t).transpose(1, 2)[live].abs().max().item()
        tol = ATOL_O[dt_name]
        ok = (o_err <= tol and lse_err <= ATOL_LSE and ctrl > tol and same
              and torch.isfinite(out[live]).all().item())
        log(f"[kernel] {name:18s} B{b} T{t} H{h}/{hkv} D{d} {dt_name:8s} "
            f"window={window} O err {o_err:.3e} (atol {tol:g})  lse err {lse_err:.3e} "
            f"(atol {ATOL_LSE:g})  control ({control}) {ctrl:.3e}"
            f"{'  rerun bit-identical' if dtype == torch.bfloat16 and same else ''}"
            f"{'' if same else '  RERUN DIFFERS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash kernel disagrees with its plain version: {name}")
        errors[f"{name} {dt_name}"] = o_err
    return errors


def _time_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(b, t, h, hkv, d, elt_bytes, dtype_name, causal=True):
    """Least time for the work: (bytes moved, flops, bound ms, bound_by)."""
    moved = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt_bytes + 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
    return moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing(torch, smi: str, shape=PATH_SHAPE, iters: int = 100) -> dict:
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    b, t, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _qkv(torch, gen, b, t, h, hkv, d, torch.bfloat16)
    with torch.inference_mode():
        ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True), iters=iters)
        plain_ms = _time_ms(torch, lambda: flash_attention_fwd_reference(q, k, v, causal=True),
                            iters=max(5, iters // 10), warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            iters=iters,
        )
    moved, flops, bound_ms, bound_by = flash_bound(b, t, h, hkv, d, 2, "bfloat16")
    log(f"[timing] flash_attention_fwd at (B,T,H,D)=({b},{t},{h},{d}) bf16 causal on {smi}:")
    log(f"[timing]   kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa (yardstick) {library_ms:.4f} ms")
    log(f"[timing]   bound {bound_ms:.6f} ms by {bound_by} ({moved} bytes at 3.35 TB/s, "
        f"{flops} flop at 989 TFLOP/s bf16); kernel at {bound_ms / ms:.2%} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# Backward tolerances, relative to the largest magnitude of the plain
# version's output: bf16 outputs are rounded once on each side from f32
# sums taken in another order, so they may differ by one bf16 ulp of the
# largest element (2^-8) -- the limit allows two; f32 outputs differ only
# in summation order and expf rounding.
BWD_RTOL = {"bfloat16": 2**-7, "float32": 1e-4}
# Fused LayerNorm: y, s and ds as above; mean/rstd (f32 either way) and
# dscale/dbias (f32 sums over every token, in another order) relative.
LN_RTOL = {"bfloat16": 2**-7, "float32": 1e-5}
LN_STATS_RTOL = 1e-5
LN_PARAM_GRAD_RTOL = 1e-4


def _rel_err(torch, got, ref, rows=None, denom=None) -> float:
    """max |got - ref| over the largest |ref| (or over ``denom``)."""
    got, ref = got.float(), ref.float()
    if rows is not None:
        got, ref = got[rows], ref[rows]
    scale = ref.abs().max().clamp_min(1e-30) if denom is None else denom
    return ((got - ref).abs().max() / scale).item()


def phase_bwd_checks(torch) -> dict:
    """Kernels 2 and 3 (dq, dk/dv) against their plain version, on the
    forward kernel's (out, lse); a control per case: the plain version
    broken on purpose, delta left out and lse off by log 2 (P halved),
    must land above the tolerance on dq, dk and dv. bf16 cases launch
    both kernels twice: dQ, dK and dV must be bit-identical. At T = 1 the
    exact dq and dk are 0 (a softmax over one key has no gradient in its
    logit), so both sides are rounding noise; there dq and dk are held,
    with the same tolerance, relative to the largest |dV| of the plain
    version instead of their own."""
    from llmtrain_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = [("train shape", TRAIN_SHAPE, "bfloat16", False, 0), *FLASH_CASES]
    errors = {}
    for name, (b, t, h, hkv, d), dt_name, segmented, window in cases:
        dtype = getattr(torch, dt_name)
        q, k, v = _qkv(torch, gen, b, t, h, hkv, d, dtype)
        dout = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
        mask = None
        if segmented:
            mask = _segments(torch, b, t)
            # The model zeroes padded rows after out_proj, so their dO is 0.
            dout = dout * (mask != 0)[:, :, None, None].to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True, window=window)
        delta = fa.attention_delta(out, dout)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, window=window)
        dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, mask, window=window)
        same = True
        if dtype == torch.bfloat16:
            dq2 = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, window=window)
            dk2, dv2 = fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, mask, window=window)
            same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        torch.cuda.synchronize()
        ref = fa._bwd_reference_from_delta(q, k, v, dout, lse, delta, mask, True, window)
        broken = fa._bwd_reference_from_delta(
            q, k, v, dout, lse + math.log(2.0), torch.zeros_like(delta), mask, True, window
        )
        tol = BWD_RTOL[dt_name]
        grads = dict(zip(("dq", "dk", "dv"), (dq, dk, dv)))
        refs = dict(zip(("dq", "dk", "dv"), ref))
        scale = {n: None for n in grads}
        if t == 1:
            scale["dq"] = scale["dk"] = refs["dv"].float().abs().max().item()
        errs = {n: _rel_err(torch, grads[n], refs[n], denom=scale[n]) for n in grads}
        ctrl = {n: _rel_err(torch, got, r) for n, got, r in zip(grads, grads.values(), broken)}
        finite = all(torch.isfinite(x).all().item() for x in (dq, dk, dv))
        ok = finite and same and max(errs.values()) <= tol and min(ctrl.values()) > tol
        log(f"[bwd] {name:18s} B{b} T{t} H{h}/{hkv} D{d} {dt_name:8s} window={window} "
            + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (rtol {tol:g}{', dq/dk relative to max |dV|' if t == 1 else ''}); control "
            + " ".join(f"{n} {e:.2e}" for n, e in ctrl.items())
            + f"{'  dq, dk/dv rerun bit-identical' if dtype == torch.bfloat16 and same else ''}"
            + f"{'' if same else '  RERUN DIFFERS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash backward kernels disagree with their plain version: {name}")
        errors[f"{name} {dt_name}"] = {n: (grads[n].float() - refs[n].float()).abs().max().item()
                                       for n in grads}
        del ref, broken
    return errors


# Cases of the LayerNorm check phase: (name, tokens, width, dtype name,
# residual or not, mean of the cotangent gy). The training path's (32768,
# 768) and around it: a ragged count, one row, the width of d_model 384,
# and widths the backward kernel takes on its general path (d = 100 in
# bf16, not whole 16-byte vectors; d = 2048, above its register path) or
# with masked lanes (d = 100 in f32: 25 vectors of four). The one row's gy
# has mean 1: with zero-mean noise one row's mean(dxhat) is ~0.04, and the
# control that leaves it out falls under 2^-7 for 40% of seeds.
NORM_CASES = [
    ("train tokens, residual", LN_TOKENS, LN_DIM, "bfloat16", True, 0.0),
    ("train tokens", LN_TOKENS, LN_DIM, "bfloat16", False, 0.0),
    ("f32, residual", LN_TOKENS, LN_DIM, "float32", True, 0.0),
    ("ragged 32731, residual", LN_TOKENS - 37, LN_DIM, "bfloat16", True, 0.0),
    ("ragged 1001 f32", 1001, LN_DIM, "float32", False, 0.0),
    ("d 384, residual", LN_TOKENS, 384, "bfloat16", True, 0.0),
    ("d 100 f32", 1001, 100, "float32", False, 0.0),
    ("d 100 (general path)", 4099, 100, "bfloat16", True, 0.0),
    ("d 2048 (general path)", 3000, 2048, "bfloat16", False, 0.0),
    ("n = 1", 1, LN_DIM, "bfloat16", True, 1.0),
]


def phase_norm_checks(torch) -> dict:
    """Kernels 4 and 5 (fused add+LayerNorm forward, Triton, and backward,
    CUDA) against their plain versions over NORM_CASES; the backward both
    without and with the residual stream's gradient gs (dx = ds + gs with
    the two roundings of ``(ds + gs).to(dtype)``). Controls: the forward
    without its bias and the backward without its mean(dxhat) term must
    land above the tolerances. bf16 cases run the backward twice: ds, dx,
    dscale and dbias must be bit-identical. The first call also compiles
    the Triton forward (timed)."""
    from llmtrain_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(11)
    gen_gs = torch.Generator(device="cuda").manual_seed(14)
    errors = {}
    for i, (name, n, d, dt_name, with_res, gy_mean) in enumerate(NORM_CASES):
        dtype = getattr(torch, dt_name)
        x = (torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        res = torch.randn(n, d, device="cuda", generator=gen).to(dtype) if with_res else None
        scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        bias = 0.5 * torch.randn(d, device="cuda", generator=gen)
        gy = (torch.randn(n, d, device="cuda", generator=gen) + gy_mean).to(dtype)
        gs = torch.randn(n, d, device="cuda", generator=gen_gs).to(dtype)
        t0 = time.perf_counter()
        y, s, mean, rstd = fn.fused_norm_fwd(x, res, scale, bias)
        ds, dscale, dbias = fn.fused_norm_bwd(s, scale, mean, rstd, gy)
        dx, dscale_gs, dbias_gs = fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs)
        torch.cuda.synchronize()
        if i == 0:
            log(f"[norm] first calls (Triton compile of the forward): "
                f"{time.perf_counter() - t0:.2f}s")
        same = True
        if dtype == torch.bfloat16:
            again = (*fn.fused_norm_bwd(s, scale, mean, rstd, gy),
                     *fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs))
            same = all(torch.equal(a, b) for a, b in zip(
                again, (ds, dscale, dbias, dx, dscale_gs, dbias_gs)))
        ry, rs, rmean, rrstd = fn.fused_norm_fwd_reference(x, res, scale, bias)
        rds, rdscale, rdbias = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy)
        rdx = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy, gs)[0]
        tol = LN_RTOL[dt_name]
        errs = {
            "y": (_rel_err(torch, y, ry), tol),
            "s": (_rel_err(torch, s, rs), tol),
            "mean": ((mean - rmean).abs().max().item() / rmean.abs().max().item(), LN_STATS_RTOL),
            "rstd": (_rel_err(torch, rstd, rrstd), LN_STATS_RTOL),
            "ds": (_rel_err(torch, ds, rds), tol),
            "dx": (_rel_err(torch, dx, rdx), tol),
            "dscale": (_rel_err(torch, dscale, rdscale), LN_PARAM_GRAD_RTOL),
            "dbias": (_rel_err(torch, dbias, rdbias), LN_PARAM_GRAD_RTOL),
        }
        no_bias = fn.fused_norm_fwd_reference(x, res, scale, torch.zeros_like(bias))[0]
        sf = s.float()
        xhat = (sf - mean[:, None]) * rstd[:, None]
        dxhat = gy.float() * scale
        no_m1 = rstd[:, None] * (dxhat - xhat * (dxhat * xhat).mean(1, keepdim=True))
        ctrl = {"y": _rel_err(torch, y, no_bias), "ds": _rel_err(torch, ds, no_m1)}
        finite = all(torch.isfinite(t).all().item() for t in (y, s, ds, dx, dscale, dbias))
        # With gs the parameter gradients are the same sums.
        params_same = torch.equal(dscale, dscale_gs) and torch.equal(dbias, dbias_gs)
        ok = (finite and same and params_same and all(e <= lim for e, lim in errs.values())
              and ctrl["y"] > tol and ctrl["ds"] > tol)
        log(f"[norm] {name:24s} ({n}, {d}) {dt_name:8s} "
            + " ".join(f"{k} {e:.2e}/{lim:g}" for k, (e, lim) in errs.items())
            + f"; control y-without-bias {ctrl['y']:.2e}, ds-without-mean(dxhat) "
            f"{ctrl['ds']:.2e}"
            f"{'  reruns bit-identical' if dtype == torch.bfloat16 and same else ''}"
            f"{'' if same else '  RERUN DIFFERS'}"
            f"{'' if params_same else '  DSCALE/DBIAS DIFFER WITH GS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fused norm kernels disagree with their plain versions: {name}")
        errors[name] = {"fwd": (y.float() - ry.float()).abs().max().item(),
                        "bwd": max((ds.float() - rds.float()).abs().max().item(),
                                   (dx.float() - rdx.float()).abs().max().item(),
                                   (dscale - rdscale).abs().max().item(),
                                   (dbias - rdbias).abs().max().item())}
    return errors


def norm_bwd_bounds(n, d, elt_bytes):
    """(bytes, ms) of the LayerNorm backward without and with the residual's
    gradient: s and dy in, dx out, scale, mean/rstd and dscale/dbias once;
    the gs flavour reads one more (n, d) tensor. Bound by bytes."""
    moved = 3 * n * d * elt_bytes + d * 4 + 2 * n * 4 + 2 * d * 4
    with_gs = moved + n * d * elt_bytes
    return tuple((b, b / H100_HBM_BYTES_PER_S * 1e3) for b in (moved, with_gs))


def bwd_bounds(b, t, h, hkv, d, elt_bytes, dtype_name):
    """(dq bound, dkdv bound) as (bytes, flop, ms, bound_by): each kernel
    reads q, k, v, dO, lse and delta once and writes its outputs once;
    dq does 3 products per live causal pair (S, dP, dQ), dk/dv 4 (S, dP,
    dV, dK), 2*D flop each."""
    pairs = b * h * (t * (t + 1) // 2)
    reads = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt_bytes + 2 * 4 * b * h * t
    out = []
    for writes, products in ((b * t * h * d * elt_bytes, 3), (2 * b * t * hkv * d * elt_bytes, 4)):
        moved = reads + writes
        flops = products * 2 * d * pairs
        t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
        out.append((moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return out


def phase_bwd_timing(torch, smi: str) -> dict:
    """CUDA-event ms of kernels 2 and 3 at the training shape, the plain
    version (all three gradients in one call), and aten's SDPA backward
    as a yardstick (all three gradients; never called by the port)."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import flash_attention as fa

    b, t, h, hkv, d = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = _qkv(torch, gen, b, t, h, hkv, d, torch.bfloat16)
    dout = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(out, dout)
    with torch.no_grad():
        dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                         iters=20, warmup=3)
        dkdv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta),
                           iters=20, warmup=3)
        plain_ms = _time_ms(
            torch, lambda: fa._bwd_reference_from_delta(q, k, v, dout, lse, delta, None, True, 0),
            iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    g = dout.transpose(1, 2)
    library_ms = _time_ms(torch, lambda: torch.autograd.grad(ref_out, (qt, kt, vt), g,
                                                             retain_graph=True),
                          iters=20, warmup=3)
    (dq_b, dq_f, dq_bound, dq_by), (kv_b, kv_f, kv_bound, kv_by) = bwd_bounds(
        b, t, h, hkv, d, 2, "bfloat16")
    log(f"[timing] flash backward at (B,T,H,D)=({b},{t},{h},{d}) bf16 causal on {smi}:")
    log(f"[timing]   dq kernel {dq_ms:.4f} ms (bound {dq_bound:.4f} ms by {dq_by}: {dq_b} bytes, "
        f"{dq_f} flop)")
    log(f"[timing]   dk/dv kernel {dkdv_ms:.4f} ms (bound {kv_bound:.4f} ms by {kv_by}: {kv_b} "
        f"bytes, {kv_f} flop)")
    log(f"[timing]   plain version (dq, dk, dv) {plain_ms:.4f} ms  sdpa backward (yardstick) "
        f"{library_ms:.4f} ms")
    return {
        "dq": dict(ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=dq_bound,
                   bound_by=dq_by),
        "dkdv": dict(ms=dkdv_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=kv_bound,
                     bound_by=kv_by),
    }


def _device_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call of ``fn``: torch.profiler over ``iters`` calls,
    the sum of the CUDA durations of the kernels they launched, over
    ``iters``. For kernels short enough that the host may set their event
    time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def phase_norm_timing(torch, smi: str) -> dict:
    """Kernels 4 and 5 at the training path's tokens (32768, 768) bf16:
    CUDA-event ms over back-to-back calls and device ms (profiler), without
    the residual (the function F.layer_norm computes, timed beside it as
    the yardstick) and with it (ln_2's variant: the forward adds the
    residual, the backward adds its gradient gs); the plain versions;
    bounds from the bytes each must move."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import fused_norm as fn

    n, d = LN_TOKENS, LN_DIM
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    res = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    scale = torch.ones(d, device="cuda")
    bias = torch.zeros(d, device="cuda")
    gy = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    gs = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        fwd = lambda: fn.fused_norm_fwd(x, None, scale, bias)  # noqa: E731
        fwd_ms, fwd_dev = _time_ms(torch, fwd), _device_ms(torch, fwd)
        fwd_res_ms = _time_ms(torch, lambda: fn.fused_norm_fwd(x, res, scale, bias))
        _, s, mean, rstd = fn.fused_norm_fwd(x, None, scale, bias)
        bwd = lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy)  # noqa: E731
        bwd_gs = lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs)  # noqa: E731
        bwd_ms, bwd_dev = _time_ms(torch, bwd), _device_ms(torch, bwd)
        gs_ms, gs_dev = _time_ms(torch, bwd_gs), _device_ms(torch, bwd_gs)
        fwd_plain = _time_ms(torch, lambda: fn.fused_norm_fwd_reference(x, None, scale, bias))
        bwd_plain = _time_ms(torch, lambda: fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy))
        gs_plain = _time_ms(torch, lambda: fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy,
                                                                        gs))
        lib_fwd = _time_ms(torch, lambda: F.layer_norm(x, (d,), scale.to(x.dtype),
                                                        bias.to(x.dtype), 1e-6))
    xr = x.detach().requires_grad_(True)
    w = scale.to(x.dtype).requires_grad_(True)
    bb = bias.to(x.dtype).requires_grad_(True)
    y_lib = F.layer_norm(xr, (d,), w, bb, 1e-6)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(y_lib, (xr, w, bb), gy,
                                                          retain_graph=True))
    fwd_bytes = 2 * n * d * 2 + 2 * d * 4 + 2 * n * 4  # x in, y out, params, mean/rstd out
    fwd_bound = fwd_bytes / H100_HBM_BYTES_PER_S * 1e3
    (bwd_bytes, bwd_bound), (gs_bytes, gs_bound) = norm_bwd_bounds(n, d, 2)
    log(f"[timing] fused LayerNorm at ({n}, {d}) bf16 on {smi}:")
    log(f"[timing]   fwd kernel {fwd_ms:.4f} ms, device {fwd_dev:.4f} ms (with residual "
        f"{fwd_res_ms:.4f} ms)  plain {fwd_plain:.4f} ms  F.layer_norm (yardstick) {lib_fwd:.4f} ms"
        f"  bound {fwd_bound:.4f} ms by bytes ({fwd_bytes} bytes)")
    log(f"[timing]   bwd kernel {bwd_ms:.4f} ms, device {bwd_dev:.4f} ms (bound {bwd_bound:.4f} ms "
        f"by bytes, {bwd_bytes} bytes; {bwd_bound / bwd_ms:.1%} of it by event, "
        f"{bwd_bound / bwd_dev:.1%} by device)  plain {bwd_plain:.4f} ms  F.layer_norm backward "
        f"(yardstick) {lib_bwd:.4f} ms")
    log(f"[timing]   bwd kernel with gs {gs_ms:.4f} ms, device {gs_dev:.4f} ms (bound "
        f"{gs_bound:.4f} ms by bytes, {gs_bytes} bytes; {gs_bound / gs_ms:.1%} of it by event, "
        f"{gs_bound / gs_dev:.1%} by device)  plain {gs_plain:.4f} ms")
    return {
        "fwd": dict(ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain, library_ms=lib_fwd,
                    bound_ms=fwd_bound, bound_by="bytes", ms_with_residual=fwd_res_ms),
        "bwd": dict(ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                    bound_ms=bwd_bound, bound_by="bytes", ms_with_gs=gs_ms,
                    device_ms_with_gs=gs_dev, plain_ms_with_gs=gs_plain,
                    bound_ms_with_gs=gs_bound),
    }


# ------------------------------------------------------- fused lm-head CE
CE_SHAPE = (64 * 512, 768, 50257)  # N tokens, d, V at the CE training path
# Fused CE tolerances, relative to the largest magnitude of the plain
# version's output. lse and the per-token loss are f32 sums over d in
# another order (cuBLAS f32 in the plain version; FMA chains in the f32
# kernel, tensor-core sums of 64-column chunks added in f32 in the bf16
# one): 1e-5. dh: one bf16 rounding on each side of f32 sums over V in
# another order, so two bf16 ulps of the largest element (2^-7); in f32,
# summation order over V only (1e-4). dW is always f32, summed over N in
# another order (1e-4).
CE_LOSS_RTOL = 1e-5
CE_DH_RTOL = {"bfloat16": 2**-7, "float32": 1e-4}
CE_DW_RTOL = 1e-4


def _ce_inputs(torch, gen, n, d, v, dtype, g_zero_every=0):
    """h ~ N(0, 1) (LayerNorm output scale), W ~ N(0, 49/d): logits of
    std ~7 at every d, a softmax peaked enough that the z-loss factor
    shows in the gradients (on the H100 that control lands at 2.4e-2 or
    more against the 2^-7 limit). Labels uniform over [0, V)
    and the first eight in the last tile, which is ragged; a non-uniform
    cotangent g, zero on every g_zero_every-th token (masked tokens) when
    asked."""
    h = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (7.0 / math.sqrt(d) * torch.randn(v, d, device="cuda", generator=gen)).to(dtype)
    labels = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
    labels[:8] = torch.arange(v - 8, v, device="cuda", dtype=torch.int32).clamp_min(0)
    g = torch.randn(n, device="cuda", generator=gen)
    if g_zero_every:
        g[::g_zero_every] = 0.0
    return h, w, labels, g


def phase_ce_checks(torch) -> dict:
    """Kernels 6-8 (fused lm-head CE forward, dh, dW) against their plain
    versions, each case with three controls broken on purpose in the plain
    version: the label logit read from column label + 1 (per-token loss),
    the one-hot term left out of dlogit (dh and dW), and, where z_loss > 0,
    the z-loss factor left out of g_lse (dh and dW). Every control must
    land above its tolerance. bf16 cases launch each kernel twice: lse, the
    label logit, dh and dW must be bit-identical."""
    from llmtrain_tpu_torch.ops import fused_ce as fc

    n, d, v = CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = [
        ("slice shape", (n, d, v), torch.bfloat16, 0.0, 0),
        ("slice shape z-loss", (n, d, v), torch.bfloat16, 1e-3, 0),
        ("f32 small", (1000, 256, 3001), torch.float32, 1e-3, 0),
        ("ragged N, V < tile", (777, 768, 100), torch.bfloat16, 1e-3, 0),
        ("d 64", (4096, 64, 5000), torch.bfloat16, 1e-3, 0),
        ("g with zeros", (4096, 768, 10007), torch.bfloat16, 1e-3, 3),
        ("d 96, ragged N and V", (1500, 96, 3001), torch.bfloat16, 0.0, 0),
    ]
    errors = {}
    for name, (cn, cd, cv), dtype, z_loss, g_zero in cases:
        h, w, labels, g = _ce_inputs(torch, gen, cn, cd, cv, dtype, g_zero)
        t0 = time.perf_counter()
        lse, ll = fc.fused_ce_fwd(h, w, labels)
        g_lse = fc.g_lse_from(g, lse, z_loss)
        dh = fc.fused_ce_bwd_dh(h, w, labels, lse, g_lse, g)
        dw = fc.fused_ce_bwd_dw(h, w, labels, lse, g_lse, g)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        same = True
        if dtype == torch.bfloat16:
            lse2, ll2 = fc.fused_ce_fwd(h, w, labels)
            same = (torch.equal(lse, lse2) and torch.equal(ll, ll2)
                    and torch.equal(dh, fc.fused_ce_bwd_dh(h, w, labels, lse, g_lse, g))
                    and torch.equal(dw, fc.fused_ce_bwd_dw(h, w, labels, lse, g_lse, g)))
            del lse2, ll2
        r_lse, r_ll = fc.fused_ce_fwd_reference(h, w, labels)
        r_dh, r_dw = fc.fused_ce_bwd_reference(h, w, labels, r_lse, fc.g_lse_from(g, r_lse, z_loss),
                                               g)
        per_token = lse - ll + z_loss * lse.square()
        r_per_token = r_lse - r_ll + z_loss * r_lse.square()
        dt_name = str(dtype).replace("torch.", "")
        errs = {
            "lse": (_rel_err(torch, lse, r_lse), CE_LOSS_RTOL),
            "loss": (_rel_err(torch, per_token, r_per_token), CE_LOSS_RTOL),
            "dh": (_rel_err(torch, dh, r_dh), CE_DH_RTOL[dt_name]),
            "dw": (_rel_err(torch, dw, r_dw), CE_DW_RTOL),
        }
        # Controls, each from the plain version broken on purpose.
        shifted = fc.fused_ce_fwd_reference(h, w, labels + 1)[1]
        ctrl = {"loss, label+1": (_rel_err(torch, per_token, r_lse - shifted
                                           + z_loss * r_lse.square()), CE_LOSS_RTOL)}
        no_hot = fc.fused_ce_bwd_reference(h, w, labels, r_lse, fc.g_lse_from(g, r_lse, z_loss),
                                           torch.zeros_like(g))
        ctrl["dh, no one-hot"] = (_rel_err(torch, dh, no_hot[0]), CE_DH_RTOL[dt_name])
        ctrl["dw, no one-hot"] = (_rel_err(torch, dw, no_hot[1]), CE_DW_RTOL)
        del no_hot
        if z_loss > 0.0:
            no_z = fc.fused_ce_bwd_reference(h, w, labels, r_lse, g, g)
            ctrl["dh, no z-loss"] = (_rel_err(torch, dh, no_z[0]), CE_DH_RTOL[dt_name])
            ctrl["dw, no z-loss"] = (_rel_err(torch, dw, no_z[1]), CE_DW_RTOL)
            del no_z
        finite = all(torch.isfinite(x).all().item() for x in (lse, ll, dh, dw))
        zero_rows_ok = True
        if g_zero:
            # A masked token adds nothing: its dh row is zero.
            zero_rows_ok = bool((dh[::g_zero] == 0).all().item())
        ok = (finite and zero_rows_ok and same and all(e <= lim for e, lim in errs.values())
              and all(e > lim for e, lim in ctrl.values()))
        log(f"[ce] {name:20s} N{cn} d{cd} V{cv} {dt_name:8s} z={z_loss:g} kernels {kernel_s:.2f}s "
            + " ".join(f"{k} {e:.2e}/{lim:g}" for k, (e, lim) in errs.items())
            + "; controls " + ", ".join(f"{k} {e:.2e}" for k, (e, _) in ctrl.items())
            + f"{'  reruns bit-identical' if dtype == torch.bfloat16 and same else ''}"
            + f"{'' if same else '  RERUN DIFFERS'}"
            + f"{'' if zero_rows_ok else ' (masked dh rows not zero)'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fused CE kernels disagree with their plain versions: {name}")
        errors[name] = {"fwd": max((lse - r_lse).abs().max().item(),
                                   (per_token - r_per_token).abs().max().item()),
                        "dh": (dh.float() - r_dh).abs().max().item(),
                        "dw": (dw - r_dw).abs().max().item()}
        del h, w, dh, dw, r_dh, r_dw
        torch.cuda.empty_cache()
    return errors


def ce_bounds(n, d, v, elt_bytes, dtype_name):
    """(fwd, dh, dw) bounds as (bytes, flop, ms, bound_by). Each kernel
    reads h, W and the labels once; the forward writes lse and the label
    logit (f32) and does 2*N*V*d flop; the backward kernels also read lse,
    g_lse and g, recompute the logits and contract them once more (4*N*V*d
    flop each); dh writes (N, d) in the operands' dtype, dW (V, d) f32."""
    reads = (n * d + v * d) * elt_bytes + 4 * n
    out = []
    for moved, flops in ((reads + 2 * 4 * n, 2 * n * v * d),
                         (reads + 3 * 4 * n + n * d * elt_bytes, 4 * n * v * d),
                         (reads + 3 * 4 * n + v * d * 4, 4 * n * v * d)):
        t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
        out.append((moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return out


def phase_ce_timing(torch, smi: str) -> dict:
    """CUDA-event ms of kernels 6-8 at the CE training path's shape
    (32768, 768, 50257) bf16, the plain versions, and a composite
    yardstick the port never calls: F.linear -> .float() ->
    F.cross_entropy(reduction="none"), forward, and its backward (dh and
    dW together). No single PyTorch call computes the fused function."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import fused_ce as fc

    n, d, v = CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, w, labels, g = _ce_inputs(torch, gen, n, d, v, torch.bfloat16)
    lse, _ = fc.fused_ce_fwd(h, w, labels)
    with torch.no_grad():
        fwd_ms = _time_ms(torch, lambda: fc.fused_ce_fwd(h, w, labels), iters=3, warmup=1)
        dh_ms = _time_ms(torch, lambda: fc.fused_ce_bwd_dh(h, w, labels, lse, g, g),
                         iters=3, warmup=1)
        dw_ms = _time_ms(torch, lambda: fc.fused_ce_bwd_dw(h, w, labels, lse, g, g),
                         iters=3, warmup=1)
        plain_fwd = _time_ms(torch, lambda: fc.fused_ce_fwd_reference(h, w, labels),
                             iters=1, warmup=1)
        plain_bwd = _time_ms(torch, lambda: fc.fused_ce_bwd_reference(h, w, labels, lse, g, g),
                             iters=1, warmup=1)
        comp_fwd = _time_ms(torch, lambda: F.cross_entropy(F.linear(h, w).float(), labels.long(),
                                                           reduction="none"), iters=3, warmup=1)
    hr = h.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = F.cross_entropy(F.linear(hr, wr).float(), labels.long(), reduction="none")
    comp_bwd = _time_ms(torch, lambda: torch.autograd.grad(loss, (hr, wr), g, retain_graph=True),
                        iters=3, warmup=1)
    comp_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del loss, hr, wr
    torch.cuda.empty_cache()
    (fb, ff, f_bound, f_by), (hb, hf, h_bound, h_by), (wb, wf, w_bound, w_by) = ce_bounds(
        n, d, v, 2, "bfloat16")
    log(f"[timing] fused lm-head CE at (N, d, V) = ({n}, {d}, {v}) bf16 on {smi}:")
    log(f"[timing]   fwd kernel {fwd_ms:.3f} ms (bound {f_bound:.4f} ms by {f_by}: {fb} bytes, "
        f"{ff} flop; {ff / fwd_ms / 1e9:.1f} TFLOP/s)  plain {plain_fwd:.3f} ms  composite "
        f"F.linear+cross_entropy fwd (yardstick) {comp_fwd:.3f} ms")
    log(f"[timing]   dh kernel {dh_ms:.3f} ms (bound {h_bound:.4f} ms by {h_by}: {hb} bytes, {hf} "
        f"flop; {hf / dh_ms / 1e9:.1f} TFLOP/s)  dW kernel {dw_ms:.3f} ms (bound {w_bound:.4f} ms "
        f"by {w_by}: {wb} bytes; {wf / dw_ms / 1e9:.1f} TFLOP/s)")
    log(f"[timing]   plain backward (dh and dW) {plain_bwd:.3f} ms  composite backward (dh and "
        f"dW, yardstick) {comp_bwd:.3f} ms; the composite's autograd graph held "
        f"{comp_peak:.2f} GiB above its inputs")
    # library_ms stays null: no single PyTorch call computes the fused
    # function; the composite yardstick has its own keys.
    composite = "F.linear -> .float() -> F.cross_entropy(reduction='none')"
    return {
        "fwd": dict(ms=fwd_ms, plain_ms=plain_fwd, library_ms=None, bound_ms=f_bound,
                    bound_by=f_by, composite_ms=comp_fwd, composite=composite + ", forward"),
        "dh": dict(ms=dh_ms, plain_ms=plain_bwd, library_ms=None, bound_ms=h_bound,
                   bound_by=h_by, composite_ms=comp_bwd,
                   composite=composite + ", backward (dh and dW)"),
        "dw": dict(ms=dw_ms, plain_ms=plain_bwd, library_ms=None, bound_ms=w_bound,
                   bound_by=w_by, composite_ms=comp_bwd,
                   composite=composite + ", backward (dh and dW)"),
    }


def build_path_model(torch):
    from llmtrain_tpu_torch.cli import prepare_decode_model
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries
    from llmtrain_tpu_torch.utils.logging import configure_logging

    root = Path(__file__).resolve().parent
    cfg, _, _ = load_and_validate_config(root / "configs/presets/gpt_pycorpus_tpu.yaml")
    logger = configure_logging(level="WARNING", json_output=False)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
    device = resolve_device(cfg.run.device)
    model = adapter.build_model(cfg, device)
    model = prepare_decode_model(model, "compute", logger)
    return cfg, adapter, model


def phase_model(torch, model) -> None:
    from unittest import mock

    from llmtrain_tpu_torch.ops import flash_attention as flash_ops

    ref = flash_ops.flash_attention_fwd_reference

    def broken(kind):
        def attend(q, k, v, mask=None, *, causal=True, window=0):
            if kind == "non-causal":
                return ref(q, k, v, mask, causal=False)
            if kind == "last 64 keys":
                return ref(q, k, v, mask, causal=True, window=64)
            out, lse = ref(q, k, v, mask, causal=causal, window=window)
            return torch.zeros_like(out), lse

        return attend

    gen = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, model.vocab_size, (1, model.block_size), device="cuda", generator=gen)

    def forward(attend=None):
        if attend is None:
            return model(ids).float()
        with mock.patch.object(flash_ops, "flash_attention_fwd", attend):
            return model(ids).float()

    with torch.inference_mode():
        logits = forward()
        plain = forward(ref)
        controls = {kind: (forward(broken(kind)) - plain).abs().max().item()
                    for kind in ("non-causal", "output zeroed", "last 64 keys")}
    torch.cuda.synchronize()
    shape_ok = tuple(logits.shape) == (1, model.block_size, model.vocab_size)
    finite = bool(torch.isfinite(logits).all().item())
    err = (logits - plain).abs().max().item()
    log(f"[model] GPT {model.n_layers}x{model.d_model} heads {model.n_heads} block "
        f"{model.block_size} vocab {model.vocab_size} dtype {str(model.dtype)[6:]}: "
        f"logits {tuple(logits.shape)} finite={finite} |max| {logits.abs().max().item():.3f} "
        f"kernel-vs-plain max abs diff {err:.4e} (atol {LOGITS_ATOL})")
    for kind, diff in controls.items():
        log(f"[model] control, attention {kind}: max abs diff from plain {diff:.4e} "
            f"(must exceed {LOGITS_ATOL})")
    if not (shape_ok and finite and err <= LOGITS_ATOL):
        raise RuntimeError("model forward through the kernel disagrees with the plain path")
    if min(controls.values()) <= LOGITS_ATOL:
        raise RuntimeError("the logits limit does not separate a broken attention from the "
                           "kernel's rounding")


def _post_h(url: str, body: object, timeout: float = 600.0) -> tuple[int, dict, dict]:
    """POST JSON (or raw bytes); (status, payload, headers)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


def _post(url: str, body: object, timeout: float = 600.0) -> tuple[int, dict]:
    return _post_h(url, body, timeout)[:2]


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


def phase_serve(torch, cfg, model, smi: str) -> None:
    import numpy as np

    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd
    from llmtrain_tpu_torch.serving import ServerState, make_server
    from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry

    state = ServerState(
        model=model,
        tokenizer=ByteTokenizer(),
        step=0,
        checkpoint=f"seeded init (run.seed={cfg.run.seed})",
        max_new_tokens_cap=cfg.serving.max_new_tokens_cap,
        default_max_new_tokens=cfg.serving.default_max_new_tokens,
        registry=MetricsRegistry(),
    )
    httpd = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, name="smoke-serve", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(3)
    requests = [
        ("greedy 32+32 (kv-cache)", 32, {"max_new_tokens": 32, "temperature": 0}),
        ("sampled 32+32", 32, {"max_new_tokens": 32, "temperature": 0.8, "top_k": 40,
                                "seed": 11}),
    ]
    launches = {}
    try:
        for name, prompt_len, knobs in requests:
            body = {"prompt_ids": [int(x) for x in rng.integers(0, 256, prompt_len)], **knobs}
            before = flash_attention_fwd.launches
            t0 = time.perf_counter()
            code, resp = _post(f"{base}/v1/generate", body)
            wall = time.perf_counter() - t0
            launches[name] = flash_attention_fwd.launches - before
            comp = resp.get("completion_ids", [])
            ok = (code == 200 and len(comp) == knobs["max_new_tokens"]
                  and all(0 <= c < 256 for c in comp))
            log(f"[serve] {name}: HTTP {code}, {len(comp)} tokens, latency "
                f"{resp.get('latency_ms')} ms (wall {wall * 1e3:.1f} ms), "
                f"{len(comp) / wall:.1f} tokens/s, kernel launches {launches[name]}  on {smi}")
            if not ok:
                raise RuntimeError(f"serve request {name!r} failed: {code} {resp}")
        over = {"prompt_ids": [int(x) for x in rng.integers(0, 256, 400)],
                "max_new_tokens": 160, "temperature": 0}
        code, resp = _post(f"{base}/v1/generate", over)
        log(f"[serve] greedy 400+160 (over block_size): HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("prompt + max_new_tokens > block_size was not answered with 400")
        code, resp = _post(f"{base}/v1/generate", {"prompt_ids": "not a list"})
        log(f"[serve] malformed body: HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("a malformed request was not answered with 400")
        code_h, health = _get(f"{base}/healthz")
        code_m, metrics = _get(f"{base}/metrics")
        if code_h != 200 or code_m != 200 or b"llmtrain_serve_requests_total" not in metrics:
            raise RuntimeError("/healthz or /metrics did not answer")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"[serve] healthz: {json.loads(health)['stats']}")
    if any(launches.values()):
        raise RuntimeError(f"a KV-cache request launched the flash kernel: {launches}")


REFORWARD = (400, 160)  # prompt, new tokens: total 560 > block_size 512


def phase_generate(torch, model, smi: str) -> None:
    """Greedy 400+160 through generate(): the re-forward branch."""
    import numpy as np

    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(4).integers(0, 256, (1, prompt_len)).astype(np.int32)
    before = flash_attention_fwd.launches
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=max_new, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = flash_attention_fwd.launches - before
    out = np.asarray(out)
    need = model.n_layers * max_new
    log(f"[generate] greedy {prompt_len}+{max_new} (re-forward): {wall * 1e3:.1f} ms, "
        f"{max_new / wall:.1f} tokens/s, kernel launches {launched} (>= {need} required)  "
        f"on {smi}")
    if out.shape != (1, prompt_len + max_new) or not (out >= 0).all() or not (out < 256).all():
        raise RuntimeError(f"generate() returned {out.shape} ids outside [0, 256)")
    if not np.array_equal(out[:, :prompt_len], ids):
        raise RuntimeError("generate() did not keep the prompt")
    if launched < need:
        raise RuntimeError("the re-forward branch did not go through the flash kernel")


def _kernel_share(events, device_ms: float,
                     names=("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkdv_kernel")) -> str:
    """Device time of the named kernels (by default the three flash
    kernels) in a profile, by kernel and as a share of all device kernel
    time."""
    parts, total = [], 0.0
    for name in names:
        hits = [e for e in events if name in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        total += ms
        parts.append(f"{name} {ms:.2f} ms x{sum(e.count for e in hits)}")
    return f"{', '.join(parts)}: {total:.2f} ms, {total / device_ms:.1%} of device kernel time"


def phase_profile(torch, model, smi: str) -> None:
    """torch.profiler over one more re-forward generate()."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.generation import generate

    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(5).integers(0, 256, (1, prompt_len)).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=max_new, temperature=0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"[profile] re-forward {prompt_len}+{max_new} on {smi}: wall {wall_ms:.1f} ms, "
        f"device kernel time {device_ms:.1f} ms ({device_ms / wall_ms:.1%} busy), {launches} "
        f"kernel launches ({launches / max_new:.0f} per token), "
        f"{wall_ms / max_new:.2f} ms/token")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")
    log(f"[profile] attention kernels: {_kernel_share(events, device_ms)}")



# ---------------------------------------------------------------- training
# Cuts of the preset for the smoke run (everything else is the preset's):
# max_steps, warmup_steps (the schema requires warmup <= max_steps; a
# quarter of the run, then the preset's cosine decay), the log/eval/save
# cadence (every step logged, eval and a save at TRAIN_SAVE_EVERY and at
# the end), and the corpus glob, pointed at the running interpreter's own
# standard library (the preset names /usr/local/lib/python3.12, which the
# card's machine may not have).
TRAIN_STEPS = 40
TRAIN_WARMUP = 10
TRAIN_SAVE_EVERY = 20
# The fused-norm run takes the first FUSED_STEPS steps only; inside the
# warmup the learning rate is lr * count / warmup whatever max_steps is,
# so the two runs share their schedule step for step.
FUSED_STEPS = TRAIN_WARMUP
# The last logged loss must sit this far below the first.
LOSS_DROP_MIN = 1.0
# Resume from step TRAIN_SAVE_EVERY to the end against the uninterrupted
# run: the restored params and optimizer state are bit-exact and the
# batches identical, so only nondeterministic reductions (atomics in
# aten's embedding backward) separate the two runs.
RESUME_ATOL = 2e-2
# Fused-norm run against the unfused one, per step, same init, batches
# and learning rates: the paths differ in the variance formula (two-pass
# vs flax's one-pass) and in bf16 rounding points, compounded over the
# steps (on the H100, over 40 steps the two bf16 trajectories drifted
# apart by up to 0.1 in loss; over the first 10 by 8e-4, PERF.md).
FUSED_ATOL = 5e-3


def _smoke_config(tmp: Path, name: str, **extra_model) -> Path:
    import sysconfig

    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs/presets/gpt_pycorpus_tpu.yaml").read_text())
    raw["run"]["device"] = "cuda"
    raw["data"]["cache_dir"] = str(tmp / "cache")
    raw["data"]["extra"]["globs"] = [sysconfig.get_paths()["stdlib"] + "/**/*.py"]
    raw["model"]["extra"].update(extra_model)
    raw["trainer"].update(max_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, log_every_steps=1,
                          eval_every_steps=TRAIN_SAVE_EVERY, save_every_steps=TRAIN_SAVE_EVERY)
    raw["output"]["root_dir"] = str(tmp / "runs")
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _run_cli(argv: list[str]) -> tuple[int, str]:
    """The port's CLI in-process; (exit code, stdout)."""
    import contextlib
    import io

    from llmtrain_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv)
    return code, out.getvalue()


def _logged_steps(run_dir: Path) -> dict[int, dict]:
    """step -> {loss, step_time, tokens_per_sec, mfu} from the run's
    train.log (one JSON line per record)."""
    import re

    pattern = re.compile(
        r"step=(\d+)/\d+\s+loss=(\S+)\s+lr=\S+\s+tokens_per_sec=(\S+)\s+"
        r"step_time=(\S+)s\s+mfu=(\S+)"
    )
    steps = {}
    for line in (run_dir / "logs" / "train.log").read_text().splitlines():
        m = pattern.search(json.loads(line)["message"])
        if m:
            steps[int(m.group(1))] = dict(loss=float(m.group(2)), tokens_per_sec=float(m.group(3)),
                                          step_time=float(m.group(4)), mfu=float(m.group(5)))
    return steps


def _reset_counts() -> None:
    from llmtrain_tpu_torch.ops import flash_attention as fa
    from llmtrain_tpu_torch.ops import fused_ce as fc
    from llmtrain_tpu_torch.ops import fused_norm as fn

    for fn_ in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
                fn.fused_norm_fwd, fn.fused_norm_bwd, fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                fc.fused_ce_bwd_dw):
        fn_.launches = 0


def _read_counts() -> dict:
    from llmtrain_tpu_torch.ops import flash_attention as fa
    from llmtrain_tpu_torch.ops import fused_ce as fc
    from llmtrain_tpu_torch.ops import fused_norm as fn

    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
        "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv.launches,
        "fused_norm_fwd": fn.fused_norm_fwd.launches,
        "fused_norm_bwd": fn.fused_norm_bwd.launches,
        "fused_ce_fwd": fc.fused_ce_fwd.launches,
        "fused_ce_bwd_dh": fc.fused_ce_bwd_dh.launches,
        "fused_ce_bwd_dw": fc.fused_ce_bwd_dw.launches,
    }


def _check_counts(name: str, got: dict, want: dict) -> None:
    """Every count not in ``want`` must be 0 (that path launches no such
    kernel)."""
    want = {**{k: 0 for k in got}, **want}
    log(f"[{name}] kernel launches {got}")
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise RuntimeError(f"{name}: launch counts differ from what the code implies "
                           f"(got, want): {bad}")


def phase_train(torch, smi: str, tmp: Path) -> dict:
    """`train` on gpt_pycorpus_tpu at full width and micro batch 64, then
    `--resume` from the first save, then `generate` from the final
    checkpoint. Returns what later phases and the kernels line need."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer

    cfg_path = _smoke_config(tmp, "gpt_pycorpus_smoke")
    cfg, _, _ = load_and_validate_config(cfg_path)
    t0 = time.perf_counter()
    dm = LocalTextDataModule()
    dm.setup(cfg, ByteTokenizer())
    n_train, n_val = len(dm.train_dataset()), len(dm.val_dataset())
    log(f"[train] corpus {cfg.data.extra['globs'][0]}: {n_train} train / {n_val} val windows "
        f"of {cfg.model.block_size + 1} tokens, tokenized in {time.perf_counter() - t0:.2f}s")
    eval_batches = -(-n_val // cfg.trainer.micro_batch_size)
    layers = cfg.model.n_layers
    n_evals = TRAIN_STEPS // TRAIN_SAVE_EVERY

    _reset_counts()  # the training path's counts start here
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "full", "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = Path(cfg.output.root_dir) / "full"
    steps = _logged_steps(run_dir)
    losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[train] {TRAIN_STEPS} steps of {cfg.trainer.micro_batch_size}x{cfg.model.block_size} "
        f"tokens in {wall:.1f}s (command wall, data setup and compile included); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; val {summary['final_val_loss']:.4f}; "
        f"peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    log(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    _check_counts("train", counts, {
        "flash_attention_fwd": layers * (TRAIN_STEPS + n_evals * eval_batches),
        "flash_attention_bwd_dq": layers * TRAIN_STEPS,
        "flash_attention_bwd_dkdv": layers * TRAIN_STEPS,
        "fused_norm_fwd": 0, "fused_norm_bwd": 0,
    })
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"logged losses are not {TRAIN_STEPS} finite values: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"loss did not fall by {LOSS_DROP_MIN}: {losses[0]} -> {losses[-1]}")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    mfu = float(np.median([x["mfu"] for x in steady]))
    log(f"[train] steady state (median of steps 6-{TRAIN_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s bf16 peak)")

    ckpt = run_dir / "checkpoints" / f"step_{TRAIN_SAVE_EVERY:06d}.ckpt"
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "resumed",
                          "--resume", str(ckpt), "--json"])
    if code != 0:
        raise RuntimeError(f"train --resume exited {code}")
    resumed = json.loads(out)["train_result"]
    r_steps = _logged_steps(Path(cfg.output.root_dir) / "resumed")
    diffs = [abs(r_steps[i]["loss"] - steps[i]["loss"]) for i in sorted(r_steps)]
    final_diff = abs(resumed["final_loss"] - summary["final_loss"])
    log(f"[resume] from step {resumed['resumed_from_step']}: final loss {resumed['final_loss']:.6f} "
        f"vs uninterrupted {summary['final_loss']:.6f} (diff {final_diff:.2e}, atol "
        f"{RESUME_ATOL}); max logged-loss diff over steps {min(r_steps)}-{max(r_steps)} "
        f"{max(diffs):.2e}")
    if resumed["resumed_from_step"] != TRAIN_SAVE_EVERY or final_diff > RESUME_ATOL \
            or max(diffs) > RESUME_ATOL:
        raise RuntimeError("resume does not continue the uninterrupted run")

    code, out = _run_cli(["generate", "--config", str(cfg_path), "--from", str(run_dir),
                          "--prompt", "def ", "--max-new-tokens", "48", "--temperature", "0",
                          "--json"])
    if code != 0:
        raise RuntimeError(f"generate exited {code}")
    gen = json.loads(out)
    ids = gen["completion_ids"]
    log(f"[generate] from the final checkpoint (step {gen['step']}), greedy 'def ' + 48: "
        f"{gen['text']!r}")
    if len(ids) != 48 or not all(0 <= i < 256 for i in ids):
        raise RuntimeError(f"generate from the trained checkpoint returned {ids}")
    return dict(cfg_path=cfg_path, run_dir=run_dir, steps=steps, counts=counts,
                eval_batches=eval_batches, step_ms=step_ms, tokens_per_sec=tok_s, mfu=mfu,
                summary=summary)


def phase_fused_train(torch, smi: str, tmp: Path, train: dict) -> dict:
    """The same config with model.extra.fused_norm: true (same init,
    batches and learning rates) through `train` for FUSED_STEPS steps:
    losses per step within FUSED_ATOL of the unfused run's; LN launches
    24 fwd + 24 bwd per step, 24 fwd per eval batch. Logs the median step
    time from step 6 on, tokens/s and peak memory."""
    import numpy as np
    import yaml

    from llmtrain_tpu_torch.config import load_and_validate_config

    cfg_path = _smoke_config(tmp, "gpt_pycorpus_smoke_fused", fused_norm=True)
    raw = yaml.safe_load(cfg_path.read_text())
    raw["trainer"].update(max_steps=FUSED_STEPS, save_every_steps=FUSED_STEPS,
                          eval_every_steps=FUSED_STEPS)
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, _ = load_and_validate_config(cfg_path)
    _reset_counts()  # the fused-norm training path's counts start here
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "fused", "--json"])
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"fused-norm train exited {code}")
    summary = json.loads(out)["train_result"]
    steps = _logged_steps(Path(cfg.output.root_dir) / "fused")
    diffs = {i: abs(steps[i]["loss"] - train["steps"][i]["loss"]) for i in sorted(steps)}
    fused_losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[fused] losses: {' '.join(f'{x:.4f}' for x in fused_losses)}")
    log(f"[fused] per-step |fused - unfused| max {max(diffs.values()):.2e} (atol {FUSED_ATOL}): "
        + " ".join(f"{d:.1e}" for d in diffs.values()))
    layers = cfg.model.n_layers
    forwards = FUSED_STEPS + train["eval_batches"]
    _check_counts("fused", counts, {
        "flash_attention_fwd": layers * forwards,
        "flash_attention_bwd_dq": layers * FUSED_STEPS,
        "flash_attention_bwd_dkdv": layers * FUSED_STEPS,
        "fused_norm_fwd": 2 * layers * forwards,
        "fused_norm_bwd": 2 * layers * FUSED_STEPS,
    })
    if len(diffs) != FUSED_STEPS or max(diffs.values()) > FUSED_ATOL:
        raise RuntimeError("the fused-norm run does not agree with the unfused one")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    unfused_ms = float(np.median([train["steps"][i]["step_time"] for i in sorted(steps)
                                  if i > 5])) * 1e3
    log(f"[fused] steady state (median of steps 6-{FUSED_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, peak memory {summary['peak_memory'] / 2**30:.2f} GiB; the "
        f"unfused run's same steps {unfused_ms:.1f} ms")
    return dict(cfg_path=cfg_path, counts=counts, step_ms=step_ms, tokens_per_sec=tok_s,
                summary=summary)


# ------------------------------------------------ CE train (GPT-2 vocabulary)
# The slice's configuration: _smoke_config (gpt_pycorpus_tpu at full width,
# micro batch 64 x 512) with model.vocab_size 50257, the GPT-2 tokenizer's
# n_vocab, and loss_impl unset, so it resolves to fused_ce as in JAX. The
# labels stay byte ids (< 256); the lm-head and the loss still run over
# all 50257 columns. Cuts: CE_STEPS steps (warmup TRAIN_WARMUP), one eval
# and one save, at the end.
CE_VOCAB = 50257
CE_STEPS = 16
# Per-step |fused_ce - dense| over the CE_STEPS steps, same init, batches
# and learning rates: the dense path rounds the logits to bf16 before its
# f32 loss, the fused path keeps them in f32, and both sum in other orders;
# the difference compounds through the updates. On the H100 the first run
# read 0 at steps 1-3, at most 5e-4 through the warmup and 1.8e-3 at step
# 12, as the two trajectories separate at the peak learning rate
# (PERF.md); the limit leaves 2.8x of that.
CE_ATOL = 5e-3
# The fused run's peak memory must sit below the dense run's by at least
# the bf16 logits of one micro batch (N x V x 2 bytes, 3.07 GiB).
CE_LOGITS_BYTES = CE_SHAPE[0] * CE_VOCAB * 2


def _ce_config(tmp: Path, name: str, **extra_model) -> Path:
    import yaml

    path = _smoke_config(tmp, name, **extra_model)
    raw = yaml.safe_load(path.read_text())
    raw["model"]["vocab_size"] = CE_VOCAB
    raw["trainer"].update(max_steps=CE_STEPS, save_every_steps=CE_STEPS, eval_every_steps=CE_STEPS)
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def phase_ce_train(torch, smi: str, tmp: Path, eval_batches: int) -> dict:
    """`train` on the slice's configuration through the fused CE kernels,
    then the same run with loss_impl: dense: resolution, launch counts,
    finite and falling losses, per-step agreement with the dense run, and
    the peak memory the kernels save."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries

    cfg_path = _ce_config(tmp, "gpt_pycorpus_smoke_ce")
    cfg, _, _ = load_and_validate_config(cfg_path)
    initialize_registries()
    built = get_model_adapter(cfg.model.name)().build_model(cfg, resolve_device(cfg.run.device))
    resolved = built.loss_impl
    del built
    torch.cuda.empty_cache()
    log(f"[ce-train] vocab {cfg.model.vocab_size}, loss_impl unset in the config -> resolved "
        f"{resolved!r}")
    if resolved != "fused_ce":
        raise RuntimeError(f"loss_impl resolved to {resolved!r}, not fused_ce")

    _reset_counts()  # the CE training path's counts start here
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "ce", "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"CE train exited {code}")
    summary = json.loads(out)["train_result"]
    steps = _logged_steps(Path(cfg.output.root_dir) / "ce")
    losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[ce-train] {CE_STEPS} steps in {wall:.1f}s (command wall, data setup included); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; val {summary['final_val_loss']:.4f}; "
        f"peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    layers = cfg.model.n_layers
    _check_counts("ce-train", counts, {
        "flash_attention_fwd": layers * (CE_STEPS + eval_batches),
        "flash_attention_bwd_dq": layers * CE_STEPS,
        "flash_attention_bwd_dkdv": layers * CE_STEPS,
        "fused_norm_fwd": 0, "fused_norm_bwd": 0,
        "fused_ce_fwd": CE_STEPS + eval_batches,
        "fused_ce_bwd_dh": CE_STEPS,
        "fused_ce_bwd_dw": CE_STEPS,
    })
    if len(losses) != CE_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"CE losses are not {CE_STEPS} finite values: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"CE loss did not fall by {LOSS_DROP_MIN}: {losses[0]} -> {losses[-1]}")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    mfu = float(np.median([x["mfu"] for x in steady]))
    log(f"[ce-train] steady state (median of steps 6-{CE_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s bf16 peak)")

    dense_path = _ce_config(tmp, "gpt_pycorpus_smoke_ce_dense", loss_impl="dense")
    code, out = _run_cli(["train", "--config", str(dense_path), "--run-id", "ce_dense", "--json"])
    if code != 0:
        raise RuntimeError(f"dense CE-vocab train exited {code}")
    dense = json.loads(out)["train_result"]
    d_steps = _logged_steps(Path(cfg.output.root_dir) / "ce_dense")
    diffs = {i: abs(steps[i]["loss"] - d_steps[i]["loss"]) for i in sorted(steps)}
    saved = (dense["peak_memory"] - summary["peak_memory"]) / 2**30
    dense_losses = [d_steps[i]["loss"] for i in sorted(d_steps)]
    d_steady = [d_steps[i] for i in sorted(d_steps) if i > 5]
    log(f"[ce-train] dense run losses {' '.join(f'{x:.4f}' for x in dense_losses)}; steady "
        f"state (median of steps 6-{CE_STEPS}) step "
        f"{float(np.median([x['step_time'] for x in d_steady])) * 1e3:.1f} ms, "
        f"{float(np.median([x['tokens_per_sec'] for x in d_steady])):.0f} tokens/s")
    log(f"[ce-train] per-step |fused - dense| max {max(diffs.values()):.2e} (atol {CE_ATOL}): "
        + " ".join(f"{x:.1e}" for x in diffs.values()))
    log(f"[ce-train] peak memory fused {summary['peak_memory'] / 2**30:.2f} GiB, dense "
        f"{dense['peak_memory'] / 2**30:.2f} GiB: {saved:.2f} GiB saved (at least "
        f"{CE_LOGITS_BYTES / 2**30:.2f} GiB required, the bf16 logits)")
    if len(diffs) != CE_STEPS or max(diffs.values()) > CE_ATOL:
        raise RuntimeError("the fused-CE run does not agree with the dense run")
    if dense["peak_memory"] - summary["peak_memory"] < CE_LOGITS_BYTES:
        raise RuntimeError("the fused-CE run does not save the logits' memory")
    return dict(cfg_path=cfg_path, counts=counts, step_ms=step_ms, tokens_per_sec=tok_s, mfu=mfu,
                summary=summary, dense=dense)


def phase_train_profile(torch, smi: str, cfg_path: Path) -> None:
    """torch.profiler over one warmed-up training step (same config, the
    Trainer built directly): wall, device kernel time, busy share, top
    kernels by device time. Measurement only."""
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.sampler import DeterministicSampler
    from llmtrain_tpu_torch.training.trainer import Trainer

    cfg, _, _ = load_and_validate_config(cfg_path)
    trainer = Trainer(cfg, None)
    ds = trainer._data_module.train_dataset()
    sampler = DeterministicSampler(len(ds), cfg.trainer.micro_batch_size, cfg.run.seed)
    for s in (1, 2):
        trainer._train_step_fn(trainer.state, trainer.global_batch(sampler, ds, s))
    batch = trainer.global_batch(sampler, ds, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer._train_step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] one training step on {smi}: wall {wall_ms:.1f} ms, device kernel time "
        f"{device_ms:.1f} ms ({device_ms / wall_ms:.1%} busy), "
        f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:5d}  {e.key[:90]}")
    log(f"[profile] attention kernels: {_kernel_share(events, device_ms)}")
    if cfg.model.extra.get("fused_norm"):
        log(f"[profile] LayerNorm kernels: "
            f"{_kernel_share(events, device_ms, ('ln_fwd', 'fused_norm_bwd_kernel'))}")


# ------------------------------------------------------- continuous serving
# Phase 14 serves phase 9's final checkpoint at the preset's serving
# defaults (max_batch_slots 8, block_tokens 16, the default pool of
# 1 + 8 x 32 blocks and power-of-two buckets). The arrival rate is past
# what 8 slots serve at this width (each request holds a slot for 64
# decode steps of 12-27 ms on the H100, PERF.md: 5-10 requests/s), so the
# batch stays full whatever the host's speed and the queue holds the rest.
CONT_REQUESTS = 48
CONT_PROMPTS = (16, 256)
CONT_NEW_TOKENS = 64
CONT_RATE_RPS = 16.0
CONT_MIN_OCCUPANCY = 6.0
CONT_SHARED_PREFIX = (128, 4)  # tokens, distinct prefixes
CONT_CHUNK = 64
CONT_HTTP_REQUESTS = 8
# Requests kept in flight across POST /reload: a batch of this many, each
# as long as the context allows after a CONT_PROMPTS[0]-token prompt.
CONT_RELOAD_REQUESTS = 8
CONT_RELOAD_NEW_TOKENS = 512 - CONT_PROMPTS[0]
CONT_PROFILE_STEPS = 20
CONT_PROFILE_PROMPT = 64
CONT_SERVER_START_SEC = 300


def _serving_config(tmp: Path, name: str, **serving) -> Path:
    """Phase 9's config (same model, same output root) with serving
    overrides."""
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["serving"] = {**raw.get("serving", {}), **serving}
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _serve_bench(cfg_path: Path, ckpt: Path, smi: str, name: str, *extra: str) -> dict:
    """One in-process `serve-bench --verify-parity` run at the phase's
    population; its gates: exit 0, bitwise parity with generate(), shapes
    within the bucket budget, every request completed, the batch full."""
    argv = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt),
            "--requests", str(CONT_REQUESTS), "--rate-rps", str(CONT_RATE_RPS),
            "--seed", "14", "--prompt-tokens-min", str(CONT_PROMPTS[0]),
            "--prompt-tokens-max", str(CONT_PROMPTS[1]),
            "--max-new-tokens", str(CONT_NEW_TOKENS), "--verify-parity", *extra]
    t0 = time.perf_counter()
    code, out = _run_cli(argv)
    wall = time.perf_counter() - t0
    summary = json.loads(out)
    block = summary["serving"]
    slo, tput, occ = block["slo"], block["throughput"], block["occupancy"]
    log(f"[continuous] {name}: exit {code}, {CONT_REQUESTS} requests at {CONT_RATE_RPS} rps "
        f"Poisson open loop on {smi}: {tput['tokens_per_sec']} output tokens/s over "
        f"{tput['wall_sec']} s (command {wall:.1f} s with parity); TTFT p50 "
        f"{slo['ttft_ms']['p50']} p99 {slo['ttft_ms']['p99']} ms; per-token p50 "
        f"{slo['per_token_ms']['p50']} p99 {slo['per_token_ms']['p99']} ms; occupancy mean "
        f"{occ['mean']} peak {occ['peak']} of {occ['max_batch_slots']}")
    log(f"[continuous] {name}: requests {block['requests']}; parity {block['parity']}; "
        f"shapes {block['compile']}")
    if "prefix_cache" in block:
        log(f"[continuous] {name}: prefix cache {block['prefix_cache']}")
    ok = (code == 0 and summary["ok"] and block["parity"]["bitwise_identical"]
          and block["compile"]["within_budget"] and block["requests"]["failed"] == 0
          and block["requests"]["timed_out"] == 0
          and block["requests"]["completed"] == CONT_REQUESTS)
    if not ok:
        raise RuntimeError(f"serve-bench {name} failed its gates: {summary.get('failures')}")
    if occ["mean"] < CONT_MIN_OCCUPANCY:
        raise RuntimeError(f"serve-bench {name}: mean occupancy {occ['mean']} below "
                           f"{CONT_MIN_OCCUPANCY}; the rate does not fill the batch")
    return block


def _decode_profile(torch, cfg_path: Path, ckpt: Path, smi: str) -> None:
    """torch.profiler over CONT_PROFILE_STEPS scheduler steps with 8 rows
    decoding (the engine of serve-bench, built in-process): launches,
    device time and wall per decode step. Measurement only."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch import cli
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.serving import (
        ContinuousBatchingScheduler,
        PagedDecodeEngine,
        ServeRequest,
    )
    from llmtrain_tpu_torch.utils.logging import get_logger

    cfg, _, _ = load_and_validate_config(cfg_path)
    _, _, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device), get_logger())
    model, _, _ = cli._load_decode_params(cfg, model, str(ckpt), "compute", get_logger())
    scheduler = ContinuousBatchingScheduler(PagedDecodeEngine(model, max_batch_slots=8))
    rng = np.random.default_rng(15)
    for i in range(8):
        scheduler.submit(ServeRequest(prompt_ids=rng.integers(0, 256, CONT_PROFILE_PROMPT)
                                      .astype(np.int32),
                                      max_new_tokens=CONT_PROFILE_STEPS + 8, seed=i))
    for _ in range(3):  # admits all 8, then two warm decode steps
        scheduler.step()
    if scheduler.stats()["active_sequences"] != 8:
        raise RuntimeError("the profiled decode steps do not hold 8 rows")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(CONT_PROFILE_STEPS):
            scheduler.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    n = CONT_PROFILE_STEPS
    log(f"[continuous] decode step at batch 8, {n} steps profiled on {smi}: wall "
        f"{wall_ms / n:.2f} ms, device kernel time {device_ms / n:.2f} ms "
        f"({device_ms / wall_ms:.1%} busy), {launches / n:.0f} kernel launches per step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[continuous]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")


def _start_server(cfg_path: Path, ckpt: Path, log_path: Path):
    """`python -m llmtrain_tpu_torch serve --mode continuous --port 0` as a
    child process; (process, base url) once its ready line arrives."""
    root = Path(__file__).resolve().parent
    err = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "serve", "--config", str(cfg_path),
         "--from", str(ckpt), "--mode", "continuous", "--port", "0"],
        cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
    )
    err.close()
    timer = threading.Timer(CONT_SERVER_START_SEC, proc.kill)
    timer.start()
    line = proc.stdout.readline()
    timer.cancel()
    if not line:
        proc.kill()
        raise RuntimeError(f"serve --mode continuous did not start: "
                           f"{log_path.read_text()[-2000:]}")
    return proc, f"http://127.0.0.1:{json.loads(line)['port']}"


def _stop_server(proc) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _http_phase(torch, tmp: Path, cfg_path: Path, ckpt: Path, smi: str) -> None:
    """`serve --mode continuous`: 8 concurrent greedy requests equal to the
    simple-mode server's answers, /healthz and /metrics, POST /reload with
    a request in flight; a second server with overload control
    (queue_cap 1) answers a burst with at least one 429 + Retry-After."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from llmtrain_tpu_torch import cli
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.serving import ServerState, make_server
    from llmtrain_tpu_torch.utils.logging import get_logger

    over_path = _serving_config(tmp, "gpt_pycorpus_overload",
                                overload={"enabled": True, "queue_cap": 1})
    t0 = time.perf_counter()
    servers = []
    try:
        with ThreadPoolExecutor(2) as ex:
            started = [ex.submit(_start_server, path, ckpt, tmp / f"{name}.log")
                       for path, name in ((cfg_path, "serve"), (over_path, "overload"))]
            for f in started:
                servers.append(f.result())
        (proc, base), (_, over_base) = servers
        log(f"[http] two `serve --mode continuous` servers ready in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(16)
        bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, n)],
                   "max_new_tokens": CONT_NEW_TOKENS // 2, "temperature": 0}
                  for n in np.linspace(*CONT_PROMPTS, CONT_HTTP_REQUESTS).astype(int)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CONT_HTTP_REQUESTS) as ex:
            answers = list(ex.map(lambda b: _post_h(f"{base}/v1/generate", b), bodies))
        wall = time.perf_counter() - t0
        codes = [a[0] for a in answers]
        log(f"[http] {CONT_HTTP_REQUESTS} concurrent greedy requests: HTTP {codes} in "
            f"{wall * 1e3:.0f} ms on {smi}")
        if codes != [200] * CONT_HTTP_REQUESTS:
            raise RuntimeError(f"concurrent requests were not all answered 200: {answers}")

        # The simple-mode server's answers for the same bodies.
        cfg, _, _ = load_and_validate_config(cfg_path)
        _, tokenizer, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device),
                                                      get_logger())
        model, path, step = cli._load_decode_params(cfg, model, str(ckpt), "compute",
                                                    get_logger())
        state = ServerState(model=model, tokenizer=tokenizer, step=step, checkpoint=str(path))
        httpd = make_server(state, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            simple = [_post_h(f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate", b)
                      for b in bodies]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        same = [a[1]["completion_ids"] == s[1]["completion_ids"]
                for a, s in zip(answers, simple)]
        log(f"[http] tokens equal to the simple-mode server's: {same}")
        if not all(same):
            raise RuntimeError("continuous answers differ from the simple-mode server's")

        code, raw = _get(f"{base}/healthz")
        sched = json.loads(raw)["scheduler"]
        log(f"[http] /healthz {code}: requests_finished {sched['requests_finished']}, "
            f"kv_pool {sched['kv_pool']}, shapes {sched['compile']}")
        code_m, metrics = _get(f"{base}/metrics")
        if (code != 200 or sched["requests_finished"] < CONT_HTTP_REQUESTS
                or code_m != 200 or b"llmtrain_serve_kv_pool_utilization" not in metrics):
            raise RuntimeError("/healthz or /metrics do not show the scheduler")

        long_bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, CONT_PROMPTS[0])],
                        "max_new_tokens": CONT_RELOAD_NEW_TOKENS, "temperature": 0}
                       for _ in range(CONT_RELOAD_REQUESTS)]
        with ThreadPoolExecutor(CONT_RELOAD_REQUESTS) as ex:
            pending = [ex.submit(_post_h, f"{base}/v1/generate", b) for b in long_bodies]
            deadline = time.monotonic() + 120
            while (json.loads(_get(f"{base}/healthz")[1])["scheduler"]["active_sequences"]
                   < CONT_RELOAD_REQUESTS):
                if time.monotonic() > deadline or any(f.done() for f in pending):
                    raise RuntimeError("the long requests never went in flight together")
                time.sleep(0.01)
            t0 = time.perf_counter()
            r_code, r_resp, _ = _post_h(f"{base}/reload", {})
            reload_ms = (time.perf_counter() - t0) * 1e3
            still_in_flight = sum(not f.done() for f in pending)
            answers = [f.result() for f in pending]
        while True:  # the swap applies between scheduler steps
            params = json.loads(_get(f"{base}/healthz")[1])["scheduler"]["params"]
            if params["hot_swaps"] or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        log(f"[http] POST /reload with {CONT_RELOAD_REQUESTS} requests in flight: HTTP {r_code} "
            f"{r_resp} in {reload_ms:.0f} ms on {smi}, {still_in_flight} requests still in "
            f"flight when it answered; params after it {params}; the requests: HTTP "
            f"{[a[0] for a in answers]}, {[len(a[1].get('completion_ids', [])) for a in answers]} "
            f"tokens")
        from llmtrain_tpu_torch.generation import generate

        first = long_bodies[0]["prompt_ids"]
        want = generate(model, np.asarray([first], np.int32), max_new_tokens=CONT_RELOAD_NEW_TOKENS,
                        temperature=0.0)[0, len(first):]
        if (r_code != 200 or still_in_flight != CONT_RELOAD_REQUESTS or params["hot_swaps"] != 1
                or any(a[0] != 200 or len(a[1]["completion_ids"]) != CONT_RELOAD_NEW_TOKENS
                       for a in answers)
                or answers[0][1]["completion_ids"] != [int(t) for t in want]):
            raise RuntimeError("the reload or the requests in flight across it failed")

        burst = [{"prompt_ids": b["prompt_ids"], "max_new_tokens": CONT_NEW_TOKENS // 4,
                  "temperature": 0}
                 for b in bodies * 2]
        with ThreadPoolExecutor(len(burst)) as ex:
            over = list(ex.map(lambda b: _post_h(f"{over_base}/v1/generate", b), burst))
        rejected = [(c, p.get("reason"), h.get("Retry-After")) for c, p, h in over if c == 429]
        log(f"[http] overload server (queue_cap 1), burst of {len(burst)}: HTTP "
            f"{[c for c, _, _ in over]}; 429s (reason, Retry-After): {rejected}")
        if not rejected or not all(ra for _, _, ra in rejected) or \
                any(c not in (200, 429) for c, _, _ in over):
            raise RuntimeError("the overload server did not answer the burst with 429 + "
                               "Retry-After")
    finally:
        for proc_, _ in servers:
            _stop_server(proc_)


def phase_continuous(torch, smi: str, tmp: Path, train: dict) -> dict:
    """Phase 14: continuous serving of phase 9's final checkpoint: (a)
    greedy serve-bench, (b) sampled serve-bench with the prefix cache and
    chunked prefill, both with --verify-parity; the decode step profiled;
    (c) serve --mode continuous over HTTP."""
    ckpt = train["run_dir"] / "checkpoints"
    greedy_path = _serving_config(tmp, "gpt_pycorpus_continuous",
                                  max_new_tokens_cap=CONT_RELOAD_NEW_TOKENS)
    sampled_path = _serving_config(tmp, "gpt_pycorpus_continuous_prefix",
                                   prefix_cache=True, prefill_chunk=CONT_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the continuous-serving path's counts start here
    t0 = time.perf_counter()
    greedy = _serve_bench(greedy_path, ckpt, smi, "greedy", "--temperature", "0")
    sampled = _serve_bench(sampled_path, ckpt, smi, "sampled, prefix cache, chunked prefill",
                           "--temperature", "0.8", "--top-k", "40",
                           "--shared-prefix-tokens", str(CONT_SHARED_PREFIX[0]),
                           "--shared-prefix-count", str(CONT_SHARED_PREFIX[1]))
    peak = torch.cuda.max_memory_allocated()
    _decode_profile(torch, greedy_path, ckpt, smi)
    _http_phase(torch, tmp, greedy_path, ckpt, smi)
    counts = _read_counts()  # and end here
    log(f"[continuous] phase 14 in {time.perf_counter() - t0:.1f} s; peak device memory of the "
        f"in-process runs {peak / 2**30:.2f} GiB on {smi}")
    _check_counts("continuous", counts, {})  # the paged path runs none of the kernels
    if sampled["prefix_cache"]["hit_rate"] <= 0:
        raise RuntimeError("the shared-prefix run never hit the prefix cache")
    return dict(greedy=greedy, sampled=sampled, counts=counts, peak_memory=peak)


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import llmtrain_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    smi = phase_device(torch)
    phase_build()
    fwd_errs = phase_kernel_checks(torch)
    bwd_errs = phase_bwd_checks(torch)
    norm_errs = phase_norm_checks(torch)
    ce_errs = phase_ce_checks(torch)
    timing = phase_timing(torch, smi)
    train_timing = phase_timing(torch, smi, TRAIN_SHAPE, iters=20)
    bwd_timing = phase_bwd_timing(torch, smi)
    norm_timing = phase_norm_timing(torch, smi)
    ce_timing = phase_ce_timing(torch, smi)
    cfg, _, model = build_path_model(torch)
    phase_model(torch, model)
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    flash_attention_fwd.launches = 0  # the serving path's count starts here
    phase_serve(torch, cfg, model, smi)
    phase_generate(torch, model, smi)
    serve_launches = flash_attention_fwd.launches  # and ends here
    log(f"[main path] serve + generate: flash_attention_fwd launches: {serve_launches}")
    if serve_launches == 0:
        raise RuntimeError("the serving path never launched the flash kernel")
    phase_profile(torch, model, smi)
    del model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = phase_train(torch, smi, Path(tmp))
        fused = phase_fused_train(torch, smi, Path(tmp), train)
        phase_train_profile(torch, smi, train["cfg_path"])
        phase_train_profile(torch, smi, fused["cfg_path"])
        ce = phase_ce_train(torch, smi, Path(tmp), train["eval_batches"])
        phase_train_profile(torch, smi, ce["cfg_path"])
        phase_continuous(torch, smi, Path(tmp), train)
    paths = (train["counts"], fused["counts"], ce["counts"])
    launches = {name: sum(c[name] for c in paths) for name in paths[0]}
    launches["flash_attention_fwd"] += serve_launches
    log(f"[main path] launches over serve + generate, train, fused-norm train, CE train: "
        f"{launches}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"the main path never launched {name}")
    csrc = "llmtrain_tpu_torch/csrc/"
    pallas = "llmtrain_tpu/ops/pallas_attention.py"
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=csrc + "flash_attention_fwd.cu",
             replaces=f"{pallas}:186", max_abs_err=max(fwd_errs.values()),
             **{k: train_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
             serve_shape_ms=timing["ms"], serve_shape_plain_ms=timing["plain_ms"],
             serve_shape_library_ms=timing["library_ms"], serve_shape_bound_ms=timing["bound_ms"]),
        dict(name="flash_attention_bwd_dq", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces=f"{pallas}:278",
             max_abs_err=max(e["dq"] for e in bwd_errs.values()), **bwd_timing["dq"]),
        dict(name="flash_attention_bwd_dkdv", route="cuda",
             source=csrc + "flash_attention_bwd.cu", replaces=f"{pallas}:358",
             max_abs_err=max(max(e["dk"], e["dv"]) for e in bwd_errs.values()),
             **bwd_timing["dkdv"]),
        dict(name="fused_norm_fwd", route="triton", source="llmtrain_tpu_torch/ops/fused_norm.py",
             replaces="llmtrain_tpu/ops/fused_norm.py:110",
             max_abs_err=max(e["fwd"] for e in norm_errs.values()), **norm_timing["fwd"]),
        dict(name="fused_norm_bwd", route="cuda", source=csrc + "fused_norm_bwd.cu",
             replaces="llmtrain_tpu/ops/fused_norm.py:158",
             max_abs_err=max(e["bwd"] for e in norm_errs.values()), **norm_timing["bwd"]),
        dict(name="fused_ce_fwd", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:146",
             max_abs_err=max(e["fwd"] for e in ce_errs.values()), **ce_timing["fwd"]),
        dict(name="fused_ce_bwd_dh", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:194",
             max_abs_err=max(e["dh"] for e in ce_errs.values()), **ce_timing["dh"]),
        dict(name="fused_ce_bwd_dw", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:212",
             max_abs_err=max(e["dw"] for e in ce_errs.values()), **ce_timing["dw"]),
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[train] step {train['step_ms']:.1f} ms, {train['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {train['mfu']:.4f}, peak memory {train['summary']['peak_memory'] / 2**30:.2f} GiB")
    log(f"[fused] step {fused['step_ms']:.1f} ms, {fused['tokens_per_sec']:.0f} tokens/s, "
        f"peak memory {fused['summary']['peak_memory'] / 2**30:.2f} GiB")
    log(f"[ce-train] step {ce['step_ms']:.1f} ms, {ce['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {ce['mfu']:.4f}, peak memory {ce['summary']['peak_memory'] / 2**30:.2f} GiB "
        f"(dense {ce['dense']['peak_memory'] / 2**30:.2f} GiB)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — any phase failure fails the smoke test
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
