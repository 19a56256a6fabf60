#!/usr/bin/env python3
"""chip_smoke.py's resilience phase alone, on the card:

    python3 tools/chip_smoke_resilience.py

Runs chip_smoke.py phases 1 (device), 2 (build), 9 (`train` on
gpt_pycorpus_tpu at full width, `--resume`, `generate`) and 20 (the
guard and the spike rollback in-process, the hang watchdog and the chaos
drill in `train` children, the checkpoint's cost), with their gates. For
a change to the resilience layer, the checkpoint writer or the trainer's
loop, before the whole run.
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
    with tempfile.TemporaryDirectory(prefix="resilience_") as tmp:
        train = cs.phase_train(torch, smi, Path(tmp))
        cs.phase_resilience(torch, smi, Path(tmp), train)
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
