#!/usr/bin/env python3
"""Time generate()'s KV-cache branch of two checkouts of the port, on the card,
alternating (A, B, B, A), each in a fresh process.

    python3 tools/compare_decode_paths.py <other checkout root> [<this checkout root>]

Each process builds the GPT of configs/presets/gpt_pycorpus_tpu.yaml at full
width (768 x 12 layers, 12 heads, block 512, byte vocab) from a seeded init,
casts it to bf16 as serving does, and times greedy generate() calls: one
warm-up 32+32, two more 32+32 and one 256+64 (milliseconds, host clock around
a synchronized call). Prints one line per process with the card's name and
power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import llmtrain_tpu_torch
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.models.gpt import GPT

assert llmtrain_tpu_torch.__file__.startswith(sys.argv[1]), llmtrain_tpu_torch.__file__
model = GPT(vocab_size=256, block_size=512, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
            dtype=torch.bfloat16, param_dtype=torch.float32, attention="flash").cuda()
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
model.init_weights(gen)
model = model.to(torch.bfloat16).eval()
model.param_dtype = torch.bfloat16
rng = np.random.default_rng(3)
out = {}
for name, tp, new in (("warm-up 32+32", 32, 32), ("32+32", 32, 32), ("32+32 again", 32, 32),
                      ("256+64", 256, 64)):
    ids = rng.integers(0, 256, (1, tp)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, ids, max_new_tokens=new, temperature=0.0)
    torch.cuda.synchronize()
    out[name] = round((time.perf_counter() - t0) * 1e3, 1)
print(json.dumps(out))
'''


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else Path(__file__).resolve().parents[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        r = subprocess.run([sys.executable, "-c", CHILD, str(root)], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return 1
        print(f"[compare] {label} ({root}) on {smi}: generate() ms {r.stdout.strip()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
