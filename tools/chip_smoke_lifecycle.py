#!/usr/bin/env python3
"""chip_smoke.py's lifecycle and fleet phase alone, on the card:

    python3 tools/chip_smoke_lifecycle.py

Runs chip_smoke.py phases 1 (device), 2 (build), 9 (the byte cell's
`train`, whose run dir phase 26 copies) and 26 (`promote` on phase 9's
stream with a poisoned step rolled back and step 40 promoted; `fleet
--storm` on the card, its child started before phase 9 as the whole run
starts it with phase 20), with their gates. For a change to
lifecycle/, fleet/ or the `promote`/`fleet` handlers, before the whole run.
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
    with tempfile.TemporaryDirectory(prefix="lifecycle_") as tmp:
        storm = cs.start_storm(Path(tmp))
        try:
            train = cs.phase_train(torch, smi, Path(tmp))
            cs.clock("phase 9: train")
            life = cs.phase_lifecycle(torch, smi, Path(tmp), train, storm)
            cs.clock("phase 26: lifecycle and fleet")
        finally:
            cs.stop_child(storm)
    if life["counts"]["flash_attention_fwd"] == 0:
        raise RuntimeError("phase 26 never launched flash_attention_fwd")
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
