#!/usr/bin/env python3
"""chip_smoke.py's pipeline and autotune phases alone, on the card:

    python3 tools/chip_smoke_pipeline.py

Runs chip_smoke.py phases 1 (device), 2 (build), 24 (gpt_pipeline at the
byte cell's width and depth from phase 9's initial weights; the GPipe and
interleaved schedules against the sequential stack; generate from its
checkpoint) and 25 (plan and tune), with their gates. Phase 9 does not
run: phase 24 takes the GPT's first-step loss from one step of its own.
For a change to parallel/pipeline.py, models/gpt_pipeline.py,
interop/pipeline_convert.py or autotune/, before the whole run.
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
    with tempfile.TemporaryDirectory(prefix="pipeline_") as tmp:
        pipe = cs.phase_pipeline(torch, smi, Path(tmp), None)
        cs.clock("phase 24: the pipeline")
        cs.phase_autotune(torch, smi, Path(tmp), None)
        cs.clock("phase 25: autotune")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        if pipe["counts"][name] == 0:
            raise RuntimeError(f"phase 24 never launched {name}")
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
