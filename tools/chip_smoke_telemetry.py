#!/usr/bin/env python3
"""chip_smoke.py's telemetry phase alone, on the card:

    python3 tools/chip_smoke_telemetry.py

Runs chip_smoke.py phases 1 (device), 2 (build), 9 (`train` on
gpt_pycorpus_tpu at full width, `--resume`, `generate`), 12 (the
GPT-2-vocabulary run through the fused CE and its dense twin) and 19
(phase 9's run files, `goodput`, `profile --steps 3 --serve`, the CE
run's cost count, telemetry off against on), with their gates. For a
change to the trainer's telemetry, the trackers or the cost count, before
the whole run.
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
    with tempfile.TemporaryDirectory(prefix="telemetry_") as tmp:
        train = cs.phase_train(torch, smi, Path(tmp))
        ce = cs.phase_ce_train(torch, smi, Path(tmp), train["eval_batches"])
        cs.phase_telemetry(torch, smi, Path(tmp), train, ce)
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
