#!/usr/bin/env python3
"""chip_smoke.py's fleet phase with only what it needs, on the card:

    python3 tools/chip_smoke_fleet.py

Runs chip_smoke.py phases 1 (device), 2 (build), 9 (train: the checkpoint
the serving phases load), 14 (its two serve-bench runs; the decode-step
profile and the HTTP children are left out) and 16 (the replica router and
request tracing), with their gates, in about 270 s of command on an H100
against about 720 s for the whole smoke test. For a change to the serving
fleet or tracing, before the whole run.
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
    cs._decode_profile = lambda *a, **k: None
    cs._http_phase = lambda *a, **k: None
    with tempfile.TemporaryDirectory(prefix="fleet_") as tmp:
        train = cs.phase_train(torch, smi, Path(tmp))
        cont = cs.phase_continuous(torch, smi, Path(tmp), train)
        cs.phase_fleet(torch, smi, Path(tmp), train, cont)
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
