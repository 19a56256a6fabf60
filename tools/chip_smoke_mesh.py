#!/usr/bin/env python3
"""chip_smoke.py's mesh phase alone, on the card:

    python3 tools/chip_smoke_mesh.py

Runs chip_smoke.py phases 1 (device), 2 (build), 18(a) (the one-rank
NCCL job whose losses phase 23(a) must repeat bit for bit) and 23 (the
mesh at one rank; ring and ulysses attention at one device against
flash), with their gates. For a change to distributed/mesh.py,
autotune/plan.py, parallel/ or the sequence-parallel attention, before
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
    cs.clock("phases 1-2: device, build")
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        probe = cs._smoke_config(Path(tmp), "mesh_probe")
        ddp = cs._ddp_train(torch, smi, Path(tmp), 12, cs._eval_batches(probe))
        cs.clock("phase 18(a): the one-rank NCCL job")
        cs.phase_mesh(torch, smi, Path(tmp), ddp)
        cs.clock("phase 23: meshes at one rank")
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
