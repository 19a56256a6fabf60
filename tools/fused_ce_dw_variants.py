#!/usr/bin/env python3
"""Time variants of the fused lm-head CE's bf16 dW kernel on one H100.

Run from the root of a checkout on a machine with the card:

    python3 tools/fused_ce_dw_variants.py

It writes copies of ``llmtrain_tpu_torch/csrc/fused_ce.cu`` under
``build/dw_variants/``, each changed by text substitution, builds them and
``tools/fused_ce_dw_smem_acc.cu`` (the f32 accumulator in shared memory)
with one nvcc each, all started together, and times ``fused_ce_bwd_dw``
of each at chip_smoke's training shape (32768, 768, 50257) bf16 with CUDA
events, in turns within one process (the unchanged kernel first and
last). Per variant it prints ptxas's registers and spills, the time, and
max |dW - plain| / max |plain| against the plain version. The variants:
the kernel as it is; without the per-chunk promotion of the logits (the
tensor cores sum all of d); 256-token logits passes with two stages; and,
for timing only (their results are wrong), the kernel without its loads,
without the logits MMAs, without the dW MMAs, without reading the old dw
values, and without expf.
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
    "256-token passes, 2 stages": [
        ("constexpr int kPass = 128;", "constexpr int kPass = 256;"),
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    ],
    "no loads": [("    if (ld_tile < n_tiles) {\n      bf16* dst", "    if (false) {\n      bf16* dst")],
    "no logits MMAs": [("mma(part[", "if (false) mma(part[")],
    "no dW MMAs": [("mma(acc[2 * dp", "if (false) mma(acc[2 * dp")],
    "no old dw values": [("(tile > 0 && col < d && row < v)", "(false)")],
    "no expf": [("return expf(logit - lse) * glse", "return (logit - lse) * glse")],
}
SMEM_ACC = "f32 accumulator in shared memory"


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
        regs = [r for k, r in cs.ptxas_resources(log).items()
                if "dw_kernelI13" in k or name == SMEM_ACC]
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.dw_option_b if name == SMEM_ACC else lib.fused_ce_bwd_dw
        fn.argtypes = [p] * 7 + [i32] * (3 if name == SMEM_ACC else 4) + [p]
        libs[name] = fn

    smi = cs.phase_device(torch)
    n, d, v = cs.CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, w, labels, g = cs._ce_inputs(torch, gen, n, d, v, torch.bfloat16)
    lse, _ = fc.fused_ce_fwd(h, w, labels)
    plain = fc.fused_ce_bwd_reference(h, w, labels, lse, g, g)[1]
    stream = torch.cuda.current_stream().cuda_stream
    for name in ["as is", *[k for k in libs if k != "as is"], "as is"]:
        dw = torch.empty(v, d, device="cuda")
        args = [x.data_ptr() for x in (h, w, labels, lse, g, g, dw)] + [n, v, d]
        args += [stream] if name == SMEM_ACC else [1, stream]
        rc = libs[name](*args)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{name!r} launch returned {rc}")
        ms = cs._time_ms(torch, lambda: libs[name](*args), iters=3, warmup=1)
        err = ((dw - plain).abs().max() / plain.abs().max()).item()
        print(f"[dw variant] {name:34s} {ms:8.3f} ms  max |dW - plain| / max |plain| {err:.2e}  "
              f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
