#!/usr/bin/env python3
"""chip_smoke.py's parallelism phase alone, on the card:

    python3 tools/chip_smoke_parallel.py

Runs chip_smoke.py phases 1 (device), 2 (build), 9 (the byte cell's
`train`, whose first losses are phase 22's f32 trajectory), 18(a) (the
one-rank NCCL job phase 22(c) holds ZeRO to) and 22 (quantized matmuls,
activation tiers and remat, ZeRO with host offload), with their gates.
For a change to ops/quant.py, models/activation_policy.py, parallel/ or
the optimizer, before the whole run.
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
    cs.clock("phases 1-2: device, build")
    with tempfile.TemporaryDirectory(prefix="parallel_") as tmp:
        train = cs.phase_train(torch, smi, Path(tmp))
        cs.clock("phase 9: train")
        ddp = cs._ddp_train(torch, smi, Path(tmp), 12, train["eval_batches"])
        cs.clock("phase 18(a): the one-rank NCCL job")
        cs.phase_parallel(torch, smi, Path(tmp), train, {"ddp": ddp})
        cs.clock("phase 22: parallelism on one device")
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
