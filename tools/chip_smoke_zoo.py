#!/usr/bin/env python3
"""chip_smoke.py's model-zoo phase alone, on the card:

    python3 tools/chip_smoke_zoo.py

Runs chip_smoke.py phases 1 (device), 2 (build), 3's flash checks
(forward and backward against their plain versions, the GQA training
shapes among them), the flash kernels' timing at the GQA training shape
(64, 512, 12 query heads over 4 KV heads, 64) from phase 4, and 21 (llama_pycorpus_tpu trained at full
width and depth, its generate, serve-bench parity and HF round trip;
Qwen2, Gemma and the Mixtral layout at 4 layers; gpt_lora_ft), with their
gates. For a change to the llama family, MoE, LoRA or the HF interop,
before the whole run.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    cs.phase_build()
    cs.phase_kernel_checks(torch)
    cs.phase_bwd_checks(torch)
    cs.clock("phase 3: flash checks")
    cs.phase_timing(torch, smi, cs.GQA_TRAIN_SHAPE, iters=20)
    cs.phase_bwd_timing(torch, smi, cs.GQA_TRAIN_SHAPE)
    with tempfile.TemporaryDirectory(prefix="zoo_") as tmp:
        cs.phase_zoo(torch, smi, Path(tmp))
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
