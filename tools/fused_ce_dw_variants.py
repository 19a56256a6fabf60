#!/usr/bin/env python3
"""Time variants of the fused lm-head CE's bf16 kernels on one H100.

Run from the root of a checkout on a machine with the card:

    python3 tools/fused_ce_dw_variants.py

It writes copies of ``llmtrain_tpu_torch/csrc/fused_ce.cu`` under
``build/dw_variants/``, each changed by text substitution, builds them and
``tools/fused_ce_dw_smem_acc.cu`` (dW with its f32 accumulator in shared
memory) with one nvcc each, all started together, and times the forward,
dh and dW of each at chip_smoke's training shape (32768, 768, 50257) bf16
with CUDA events, in turns within one process (the unchanged kernels
first and last). Per variant it prints ptxas's registers and spills of
the three bf16 instances, and per kernel the time and max |out - plain| /
max |plain| against the plain version. The forward, dh and dW share one
tensor-core walk (``ce_mma::run``), so a substitution in it changes all
three. The variants: the kernels as they are; without the per-chunk
promotion of the logits (the tensor cores sum all of d); 256-column
logits passes with two stages; the forward at two blocks per SM; and, for
timing only (their results are wrong), the kernels without their loads,
without the logits MMAs, without the second product's MMAs, without
reading the old output values, and without expf in dlogit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "as is": [],
    "no promotion": [
        ("float part[2][kNT][4];", "float (&part)[2][kNT][4] = logit;"),
        ("for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;",
         "for (int e = 0; e < 4; ++e) if (dc == 0) part[mt][nt][e] = 0.0f;"),
        ("logit[mt][nt][e] = dc == 0 ? part[mt][nt][e] : logit[mt][nt][e] + part[mt][nt][e];",
         "(void)0;"),
    ],
    "256-column passes, 2 stages": [
        ("constexpr int kPass = 128;", "constexpr int kPass = 256;"),
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    ],
    "forward at 2 blocks per SM": [
        ("__launch_bounds__(kThreads, kTensorCores<T> ? 1 : 2)\nfused_ce_fwd_kernel",
         "__launch_bounds__(kThreads, 2)\nfused_ce_fwd_kernel"),
    ],
    "no loads": [("    if (ld_tile < n_tiles) {\n      bf16* dst", "    if (false) {\n      bf16* dst")],
    "no logits MMAs": [("mma(part[", "if (false) mma(part[")],
    "no second-product MMAs": [("mma(acc[2 * dp", "if (false) mma(acc[2 * dp")],
    "no old output values": [("(tile > 0 && col < d && row < own_n)", "(false)")],
    "no expf": [("return expf(logit - lse) * glse", "return (logit - lse) * glse")],
}
SMEM_ACC = "dW: f32 accumulator in shared memory"
KERNELS = ("fwd", "dh", "dw")
# Fragments of the bf16 instances' mangled names.
TAGS = {"fwd": "fwd_kernelI13", "dh": "dh_kernelI13", "dw": "dw_kernelI13"}


def main() -> int:
    import torch

    import chip_smoke as cs
    from llmtrain_tpu_torch.ops import fused_ce as fc
    from llmtrain_tpu_torch.ops.kernel_build import NVCC_FLAGS, find_nvcc

    if not torch.cuda.is_available():
        print("fused_ce_dw_variants: needs a GPU", file=sys.stderr)
        return 1
    csrc = ROOT / "llmtrain_tpu_torch" / "csrc"
    out = ROOT / "build" / "dw_variants"
    source = (csrc / "fused_ce.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate([*VARIANTS.items(), (SMEM_ACC, None)]):
        d = out / str(i)
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "tile_mma.cuh", d / "tile_mma.cuh")
        if subs is None:
            text = (ROOT / "tools" / "fused_ce_dw_smem_acc.cu").read_text()
        else:
            text = source
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"variant {name!r}: {old!r} not in fused_ce.cu")
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
        resources = cs.ptxas_resources(log)
        lib = ctypes.CDLL(str(d / "lib.so"))
        if name == SMEM_ACC:
            print(f"[ptxas] {name}: {'; '.join(resources.values())}", flush=True)
            lib.dw_option_b.argtypes = [p] * 7 + [i32] * 3 + [p]
            libs[name] = {"dw": lib.dw_option_b}
            continue
        for k in KERNELS:
            regs = [r for m, r in resources.items() if TAGS[k] in m]
            print(f"[ptxas] {name} {k}: {'; '.join(regs)}", flush=True)
        lib.fused_ce_fwd.argtypes = [p] * 5 + [i32] * 4 + [p]
        lib.fused_ce_bwd_dh.argtypes = [p] * 8 + [i32] * 4 + [p]
        lib.fused_ce_bwd_dw.argtypes = [p] * 7 + [i32] * 4 + [p]
        libs[name] = {"fwd": lib.fused_ce_fwd, "dh": lib.fused_ce_bwd_dh,
                      "dw": lib.fused_ce_bwd_dw}

    smi = cs.phase_device(torch)
    n, d, v = cs.CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, w, labels, g = cs._ce_inputs(torch, gen, n, d, v, torch.bfloat16)
    lse, _ = fc.fused_ce_fwd(h, w, labels)
    plain = {}
    plain["fwd"] = fc.fused_ce_fwd_reference(h, w, labels)[0]
    plain["dh"], plain["dw"] = fc.fused_ce_bwd_reference(h, w, labels, lse, g, g)
    stream = torch.cuda.current_stream().cuda_stream
    for name in ["as is", *[k for k in libs if k != "as is"], "as is"]:
        for k, fn in libs[name].items():
            lse_out, ll = torch.empty(n, device="cuda"), torch.zeros(n, device="cuda")
            dh_f32 = torch.empty(n, d, device="cuda")
            dh = torch.empty(n, d, device="cuda", dtype=torch.bfloat16)
            dw = torch.empty(v, d, device="cuda")
            ptrs = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
            if k == "fwd":
                args, got = ptrs(h, w, labels, lse_out, ll) + [n, v, d, 1], lse_out
            elif k == "dh":
                args, got = ptrs(h, w, labels, lse, g, g, dh_f32, dh) + [n, v, d, 1], dh
            elif name == SMEM_ACC:
                args, got = ptrs(h, w, labels, lse, g, g, dw) + [n, v, d], dw
            else:
                args, got = ptrs(h, w, labels, lse, g, g, dw) + [n, v, d, 1], dw
            args.append(stream)
            rc = fn(*args)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name!r} {k} launch returned {rc}")
            ms = cs._time_ms(torch, lambda: fn(*args), iters=3, warmup=1)
            ref = plain[k]
            err = ((got.float() - ref).abs().max() / ref.abs().max()).item()
            print(f"[variant] {name:30s} {k:3s} {ms:8.3f} ms  max |out - plain| / max |plain| "
                  f"{err:.2e}  on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
