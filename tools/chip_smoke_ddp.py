#!/usr/bin/env python3
"""chip_smoke.py's slice 2 deferrals phase alone, on the card:

    python3 tools/chip_smoke_ddp.py

Runs chip_smoke.py phases 1 (device), 2 (build) and 18 (a one-rank NCCL
`train` on gpt_pycorpus_tpu at full width with the EMA and the step
profiler against the plain run, `eval --ema`, export --ema -> import ->
eval, `generate --ema`, and Adafactor and Lion), with their gates. For a
change to the distributed runtime, the train step's reduction, the
optimizers or the EMA, before the whole run.
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
    with tempfile.TemporaryDirectory(prefix="ddp_") as tmp:
        cs.phase_ddp(torch, smi, Path(tmp))
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
