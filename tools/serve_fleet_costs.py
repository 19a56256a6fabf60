#!/usr/bin/env python3
"""What request tracing and in-process replicas cost the continuous server,
on the card, in one process.

    python3 tools/serve_fleet_costs.py [ROUNDS]

Trains the GPT of configs/presets/gpt_pycorpus_tpu.yaml at full width (768 x
12 layers, byte vocabulary, block 512) for 2 steps into a temporary directory
(chip_smoke.py's config: the interpreter's stdlib as corpus), then runs
chip_smoke.py phase 14(a)'s traffic (CONT_REQUESTS greedy requests, prompts
CONT_PROMPTS tokens, CONT_NEW_TOKENS new tokens, Poisson at CONT_RATE_RPS,
seed 14) through the in-process `serve-bench` CLI, without parity, in ROUNDS
rounds (default 4). Each round runs four variants in an order that rotates
from round to round:

* traced: the preset's telemetry (the timeline and the request tracer on,
  JAX's default);
* untraced: `telemetry.timeline: false` (no timeline, no tracer);
* router: traced, behind `--router --replicas 2` (two in-process replicas,
  each stepping on its own thread);
* router-0.5ms: the same with the interpreter's thread switch interval at
  0.5 ms (`sys.setswitchinterval`; default 5 ms) for the run: a diagnostic
  of how the two step threads share the interpreter lock.

Prints each run's output tokens/s, TTFT p50 and per-token p50/p99, then the
median of each variant, each line with the card's name and power limit as
nvidia-smi prints them.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _config(tmp: Path, name: str, timeline: bool) -> Path:
    import yaml

    path = cs._serving_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["trainer"].update(max_steps=2, eval_every_steps=2, save_every_steps=2, warmup_steps=1)
    raw["telemetry"] = {**raw.get("telemetry", {}), "timeline": timeline}
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def main() -> int:
    import torch

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if not torch.cuda.is_available():
        print("serve_fleet_costs: needs a GPU", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="fleet_costs_") as tmp_name:
        tmp = Path(tmp_name)
        traced, untraced = _config(tmp, "traced", True), _config(tmp, "untraced", False)
        code, _ = cs._run_cli(["train", "--config", str(traced), "--run-id", "w", "--json"])
        if code != 0:
            raise RuntimeError(f"train exited {code}")
        ckpt = tmp / "runs" / "w" / "checkpoints"
        router = [str(traced), "--router", "--replicas", "2"]
        variants = {"traced": [str(traced)], "untraced": [str(untraced)], "router": router,
                    "router-0.5ms": router}
        results: dict[str, list[dict]] = {k: [] for k in variants}
        names = list(variants)
        for r in range(rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                argv = ["serve-bench", "--config", *variants[name][:1], "--from", str(ckpt),
                        *variants[name][1:], "--requests", str(cs.CONT_REQUESTS),
                        "--rate-rps", str(cs.CONT_RATE_RPS), "--seed", "14",
                        "--prompt-tokens-min", str(cs.CONT_PROMPTS[0]),
                        "--prompt-tokens-max", str(cs.CONT_PROMPTS[1]),
                        "--max-new-tokens", str(cs.CONT_NEW_TOKENS), "--temperature", "0",
                        "--out", str(tmp / f"bench_{name}")]
                interval = sys.getswitchinterval()
                if name == "router-0.5ms":
                    sys.setswitchinterval(0.0005)
                try:
                    code, out = cs._run_cli(argv)
                finally:
                    sys.setswitchinterval(interval)
                if code != 0:
                    raise RuntimeError(f"serve-bench {name} exited {code}")
                block = json.loads(out)["serving"]
                row = dict(tokens_per_sec=block["throughput"]["tokens_per_sec"],
                           ttft_p50=block["slo"]["ttft_ms"]["p50"],
                           per_token_p50=block["slo"]["per_token_ms"]["p50"],
                           per_token_p99=block["slo"]["per_token_ms"]["p99"])
                results[name].append(row)
                cs.log(f"[costs] round {r} {name} on {smi}: {row}")
        for name, rows in results.items():
            med = {k: round(statistics.median(x[k] for x in rows), 3) for k in rows[0]}
            cs.log(f"[costs] median of {len(rows)} {name} runs on {smi}: {med}")
    print("serve_fleet_costs: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
