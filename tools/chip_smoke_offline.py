#!/usr/bin/env python3
"""chip_smoke.py's offline phase alone, on the card:

    python3 tools/chip_smoke_offline.py

Runs chip_smoke.py phases 1 (device), 2 (build) and 17 (train-tokenizer,
`train` on gpt_pycorpus_bpe_tpu at full width, `eval`, export -> import ->
eval, average-checkpoints, the smoke presets), with their gates, in about
95 s of command on an H100 against about 15 minutes for the whole smoke
test. For a change to the data path, the tokenizer or the checkpoint
tools, before the whole run.
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
    with tempfile.TemporaryDirectory(prefix="offline_") as tmp:
        cs.phase_offline(torch, smi, Path(tmp))
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
