"""Command-line interface of the port: ``python -m llmtrain_tpu_torch``.

Same subcommands, flags, JSON shapes and exit codes as the JAX CLI
(``llmtrain_tpu/cli.py``) for the surface this slice ports:

* ``train`` — config → run directory (``config.yaml``, ``meta.json``,
  ``logs/``, ``checkpoints/``) → the trainer (training/trainer.py), with
  ``--run-id``, ``--dry-run``, ``--json``, ``-v``, ``--resume`` and
  ``--auto-resume``; the run summary on stdout. With
  ``distributed.enabled`` every process joins the data-parallel group
  first (distributed/__init__.py; retried, exit 2 for a topology that
  cannot work and 75 for a rendezvous that failed) and only rank 0 writes
  the run directory and prints the summary;
* ``generate`` — checkpoint → ``generate()`` (KV-cache or re-forward
  branch), or speculative decoding with ``--draft-config/--draft-from/--gamma``;
  ``--quantize int8`` quantizes the weights (the draft's too);
* ``serve`` — checkpoint → HTTP server (serving/http.py): simple mode, or
  ``--mode continuous`` / ``serving.mode: continuous``, the paged-KV
  continuous-batching scheduler with overload control and ``POST /reload``;
  ``--router [--replicas N]`` puts a replica router in front of N
  in-process replicas, ``--backends URL,...`` / ``--discover HOST:PORT`` in
  front of separate ``serve`` processes; ``--trace-dir D`` writes each
  process's timeline under ``D/<name>/timeline.jsonl`` and a
  ``metrics.prom`` snapshot;
* ``serve-bench`` — checkpoint → a seeded open-loop load against the
  continuous-batching scheduler (or, with ``--router``, the replica
  router), its SLO block as JSON, the bounded-shape, failure and latency
  gates, ``--verify-parity`` against ``generate()``, and ``report.json``,
  ``report.md`` and ``trace.json`` under ``--out``;
* ``trace slowest|show|summary|merge`` — rebuild request traces across the
  router and replica processes from their timelines;
* ``eval`` — the validation loop alone on a checkpoint (``--quantize int8``
  for the quantized serving weights);
* ``train-tokenizer`` — an offline byte-level BPE vocabulary (data/bpe.py)
  for ``model.extra.tokenizer: "bpe:<path>"``;
* ``export-checkpoint`` / ``import-checkpoint`` — a checkpoint to and from
  the reference torch GPT's state dict (interop/torch_interop.py), or HF
  Llama's for the llama family (interop/llama_hf.py); a LoRA run exports
  its merged weights, and importing into a LoRA config fills its base;
  ``average-checkpoints`` — the float64 average of several checkpoints'
  params (``--last-k``); the last two write a resumable step-0 checkpoint;
* ``validate`` / ``print-config`` — the config loader.

* ``profile`` — a few probe steps, then the cost count of one train step
  (and with ``--serve`` of the paged prefill/decode steps) written as
  ``profile_report.json`` (telemetry/profiling.py);
* ``goodput`` — the wall-clock goodput ledger of any past run directory
  (telemetry/goodput.py);
* ``chaos`` — the seeded crash-recovery drill (resilience/chaos.py):
  ``train`` child processes SIGKILLed on a schedule drawn from ``--seed``
  (one kill inside a checkpoint write, one corrupted commit) and resumed,
  the newest commit loadable after each, the finished trajectory and
  final state bitwise equal to an uninterrupted run's.

``train`` builds its tracker as JAX's does (tracking/: mlflow, the native
SQLite store or TensorBoard on rank 0 when ``mlflow.enabled``, the null
tracker otherwise) and registers ``config.yaml`` and ``meta.json`` with it.

* ``promote`` — the train -> canary -> promote lifecycle (lifecycle/): watch a
  run's checkpoint stream, canary each commit on one replica of an
  in-process router fleet, score it (eval loss, soak SLOs) and promote it
  fleet-wide or roll it back, every decision in ``promotions.jsonl``;
* ``fleet`` — the multi-tenant fleet supervisor (fleet/): tenants as groups
  of ``train --auto-resume`` ranks on a bounded pool, with ``--storm`` the
  seeded preemption-storm drill;
* ``plan`` / ``tune`` — the mesh planner and the auto-tuner (autotune/).

``serve`` and ``serve-bench`` take the same draft and quantize flags: a
draft puts the continuous backend on the speculative policy.

Exit codes: JAX's taxonomy (resilience/exit_codes.py): 0 ok, 1 failure,
2 config error (a feature that is not yet ported counts as a config
error), 75 a transient infrastructure fault (or an injected one) anywhere
in the exception's cause chain, 76 a hang the watchdog ended. A malformed
``model.extra.lora`` exits 2 before anything is built; pipeline
checkpoints exit 2 naming the ROADMAP.md item. ``--ema`` (generate, serve, serve-bench, eval,
export-checkpoint) loads the checkpoint's EMA shadow
(``trainer.extra.ema_decay``). ``run.device`` (default ``cuda``) picks
the device: ``cpu`` the CPU, ``tpu``/``cuda`` the card (an error when none
is visible).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

import numpy as np

from . import __version__
from .config import ConfigLoadError, load_and_validate_config
from .resilience.exit_codes import EXIT_TRAIN_FAILURE, exit_code_for_exception

EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_CONFIG_ERROR = 2


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="llmtrain_tpu_torch",
        description="PyTorch/CUDA port of llmtrain_tpu: training, generation and serving",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", required=True)

    train = sub.add_parser("train", help="run a training job")
    train.add_argument("--config", required=True, help="path to the YAML run config")
    train.add_argument("--run-id", default=None, help="override the generated run id")
    train.add_argument("--dry-run", action="store_true", help="forward-only sanity check")
    train.add_argument("--json", action="store_true", help="emit the run summary as JSON")
    train.add_argument("-v", "--verbose", action="store_true", help="DEBUG logging")
    resume_group = train.add_mutually_exclusive_group()
    resume_group.add_argument(
        "--resume", default=None,
        help="checkpoint file, checkpoint dir, or run id to resume from",
    )
    resume_group.add_argument(
        "--auto-resume", action="store_true",
        help="reuse the run dir for --run-id if it exists and resume from its "
        "latest checkpoint (fresh start otherwise); for preemptible pods",
    )

    gen = sub.add_parser("generate", help="sample completions from a trained checkpoint")
    gen.add_argument("--config", required=True, help="path to the YAML run config")
    gen.add_argument(
        "--from", dest="from_spec", required=True,
        help="checkpoint file, checkpoint dir, or run id to load params from",
    )
    prompt_group = gen.add_mutually_exclusive_group(required=True)
    prompt_group.add_argument("--prompt", default=None, help="prompt text (needs a tokenizer)")
    prompt_group.add_argument(
        "--prompt-ids", default=None,
        help="comma-separated token ids, bypassing the tokenizer",
    )
    prompt_group.add_argument(
        "--prompts-file", default=None,
        help="file with one prompt per line (blank lines skipped); prompts "
        "are batched per token length",
    )
    gen.add_argument("--max-new-tokens", type=int, default=48)
    gen.add_argument("--temperature", type=float, default=0.8, help="0 decodes greedily")
    gen.add_argument("--top-k", type=int, default=40, help="0 disables top-k filtering")
    gen.add_argument(
        "--top-p", type=float, default=None,
        help="nucleus sampling: keep the smallest token set with this "
        "probability mass, 0 < p < 1 (0 or 1 disables, like --top-k 0)",
    )
    gen.add_argument(
        "--eos-token-id", type=int, default=None,
        help="stop early on this token (default: the tokenizer's EOS, if any)",
    )
    gen.add_argument("--seed", type=int, default=1234)
    gen.add_argument(
        "--decode-param-dtype", choices=("compute", "param"), default="compute",
        help="'compute' (default) casts floating checkpoint params to the "
        "model compute dtype before decoding; 'param' keeps the "
        "checkpoint's master precision",
    )
    gen.add_argument(
        "--draft-config", default=None,
        help="YAML config of a DRAFT model for speculative decoding "
        "(requires --draft-from; same tokenizer/vocab as the target)",
    )
    gen.add_argument(
        "--draft-from", default=None,
        help="checkpoint file, dir, or run id for the draft model's params",
    )
    gen.add_argument(
        "--gamma", type=int, default=4,
        help="speculative lookahead: draft tokens proposed per target forward",
    )
    gen.add_argument(
        "--logprobs", action="store_true",
        help="include the model's log-probability of every emitted token in the JSON "
        "output (not supported with --draft-config)",
    )
    gen.add_argument("--ema", action="store_true",
                     help="decode with the EMA shadow weights tracked by "
                     "trainer.extra.ema_decay (errors if the checkpoint has none)")
    gen.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="weight-only quantization applied after checkpoint load (ops/quant.py); "
        "applies to the draft model too under speculative decoding",
    )
    gen.add_argument("--json", action="store_true", help="emit the result as JSON")

    serve = sub.add_parser(
        "serve", help="HTTP inference server (GET /healthz, GET /metrics, POST /v1/generate)"
    )
    serve.add_argument("--config", required=True, help="path to the YAML run config")
    serve.add_argument(
        "--from", dest="from_spec", required=True,
        help="checkpoint file, checkpoint dir, or run id to serve",
    )
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument(
        "--port", type=int, default=8000,
        help="0 binds an ephemeral port (printed on the ready line)",
    )
    serve.add_argument(
        "--max-new-tokens-cap", type=int, default=None,
        help="upper bound a request's max_new_tokens may ask for "
        "(default: serving.max_new_tokens_cap from the config)",
    )
    serve.add_argument(
        "--mode", choices=("simple", "continuous"), default=None,
        help="override serving.mode: 'simple' decodes one request at a time, "
        "'continuous' runs the paged-KV continuous-batching scheduler",
    )
    serve.add_argument(
        "--draft-config", default=None,
        help="draft model config: switches the continuous scheduler to the "
        "speculative policy (requires --draft-from)",
    )
    serve.add_argument(
        "--draft-from", default=None,
        help="checkpoint file, dir, or run id for the draft model's params",
    )
    serve.add_argument(
        "--gamma", type=int, default=None,
        help="speculative lookahead (default: serving.speculative_gamma)",
    )
    serve.add_argument(
        "--decode-param-dtype", choices=("compute", "param"), default="compute",
        help="as in generate",
    )
    serve.add_argument("--ema", action="store_true",
                       help="serve the EMA shadow weights (errors if the checkpoint has none)")
    serve.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="serve weight-only int8 quantized weights (ops/quant.py)",
    )
    serve.add_argument(
        "--eos-token-id", type=int, default=None,
        help="default stop token (requests may override; default: the tokenizer's EOS, if any)",
    )
    serve.add_argument(
        "--router", action="store_true",
        help="run the fleet tier: a replica router placing each request by "
        "prefix-cache affinity and load, with rolling zero-downtime POST "
        "/reload (needs the continuous backend)",
    )
    serve.add_argument(
        "--replicas", type=int, default=None,
        help="in-process replica count for --router (default: serving.router.replicas)",
    )
    serve.add_argument(
        "--backends", default=None,
        help="comma-separated replica base URLs (http://host:port): route across "
        "separate serve processes instead of in-process replicas (implies --router)",
    )
    serve.add_argument(
        "--discover", default=None,
        help="host[:port] DNS-resolved into one HTTP backend per address "
        "(implies --router)",
    )
    serve.add_argument(
        "--trace-dir", default=None,
        help="write per-process timeline.jsonl files (with tail-sampled request "
        "traces) plus a metrics.prom textfile snapshot under this dir, for "
        "`trace` to merge; with --router each in-process replica gets its own subdir",
    )

    bench = sub.add_parser(
        "serve-bench",
        help="seeded open-loop load generator against the continuous-batching "
        "scheduler: p50/p95/p99 TTFT + per-token latency, tokens/s, occupancy, "
        "bucketed shapes",
    )
    bench.add_argument("--config", required=True, help="path to the YAML run config")
    bench.add_argument(
        "--from", dest="from_spec", required=True,
        help="checkpoint file, checkpoint dir, or run id to serve",
    )
    bench.add_argument("--requests", type=int, default=16, help="request population size")
    bench.add_argument(
        "--rate-rps", type=float, default=8.0,
        help="open-loop Poisson arrival rate (requests/second); arrivals never "
        "wait for completions",
    )
    bench.add_argument("--seed", type=int, default=1234)
    bench.add_argument("--prompt-tokens-min", type=int, default=4, help="shortest prompt")
    bench.add_argument(
        "--prompt-tokens-max", type=int, default=0,
        help="longest prompt (0 = derived: min(32, block_size - max_new))",
    )
    bench.add_argument("--max-new-tokens", type=int, default=16)
    bench.add_argument(
        "--temperature", type=float, default=0.0,
        help="0 = greedy",
    )
    bench.add_argument("--top-k", type=int, default=None)
    bench.add_argument("--top-p", type=float, default=None)
    bench.add_argument(
        "--timeout-sec", type=float, default=300.0,
        help="give up on unfinished requests after this long",
    )
    bench.add_argument(
        "--verify-parity", action="store_true",
        help="re-decode every request through sequential generate() and assert "
        "the served token ids are bitwise identical (exits nonzero on any mismatch)",
    )
    bench.add_argument(
        "--out", default=None,
        help="report directory (default: <output.root_dir>/serve_bench)",
    )
    bench.add_argument(
        "--decode-param-dtype", choices=("compute", "param"), default="compute",
        help="as in generate/serve",
    )
    bench.add_argument("--ema", action="store_true",
                       help="bench the EMA shadow weights (errors if the checkpoint has none)")
    bench.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="weight-only int8 quantization of the served weights (ops/quant.py)",
    )
    bench.add_argument(
        "--draft-config", default=None,
        help="draft model config for the speculative scheduler policy",
    )
    bench.add_argument("--draft-from", default=None, help="draft model checkpoint/run id")
    bench.add_argument(
        "--gamma", type=int, default=None,
        help="speculative lookahead (default: serving.speculative_gamma)",
    )
    bench.add_argument(
        "--router", action="store_true",
        help="drive the replica-router tier instead of one scheduler (in-process "
        "replicas; the report gains the fleet prefix hit rate and per-replica occupancy)",
    )
    bench.add_argument(
        "--replicas", type=int, default=None,
        help="in-process replica count for --router (default: serving.router.replicas)",
    )
    bench.add_argument(
        "--shared-prefix-tokens", type=int, default=0,
        help="prepend one of --shared-prefix-count fixed 'system prompts' of this "
        "many tokens to every request (the workload shared-prefix KV reuse pays off on)",
    )
    bench.add_argument(
        "--shared-prefix-count", type=int, default=1, help="distinct shared prefixes to draw from"
    )
    bench.add_argument(
        "--long-fraction", type=float, default=0.0,
        help="fraction of requests using --long-prompt-tokens prompts (the "
        "bimodal long/short mix chunked prefill exists for)",
    )
    bench.add_argument(
        "--long-prompt-tokens", type=int, default=0, help="prompt length of the long cohort"
    )
    bench.add_argument(
        "--max-per-token-p99-ms", type=float, default=None,
        help="fail the run if per-token p99 latency exceeds this bound",
    )
    bench.add_argument(
        "--arrival", choices=("poisson", "burst"), default="poisson",
        help="arrival process: steady Poisson, or 'burst' (head/tail 20%% at "
        "--rate-rps, middle 60%% at rate * --burst-factor)",
    )
    bench.add_argument(
        "--burst-factor", type=float, default=10.0,
        help="rate multiplier for the burst window of --arrival burst",
    )
    bench.add_argument(
        "--deadline-ms", type=float, default=None,
        help="stamp every request with this latency budget; the overload controller "
        "rejects/sheds requests that cannot meet it (needs serving.overload.enabled)",
    )
    bench.add_argument(
        "--batch-fraction", type=float, default=0.0,
        help="seeded fraction of requests submitted as priority=batch",
    )
    bench.add_argument(
        "--max-rejected-frac", type=float, default=None,
        help="fail the run if (rejected+shed)/submitted exceeds this bound",
    )

    profile = sub.add_parser(
        "profile",
        help="N-step cost probe: the train step's cost count + roofline "
        "attribution (and the paged serving buckets with --serve) written as "
        "profile_report.json (telemetry/profiling.py)",
    )
    profile.add_argument("--config", required=True, help="path to the YAML run config")
    profile.add_argument(
        "--steps", type=int, default=3,
        help="probe training steps to run for measured step time (default 3)",
    )
    profile.add_argument(
        "--serve", action="store_true",
        help="also count the paged prefill/decode steps at their largest shape "
        "buckets (meta tensors; no checkpoint needed)",
    )
    profile.add_argument(
        "--top-k", type=int, default=10,
        help="op rows in each step's top-ops table (the hand-written kernels are "
        "always listed)",
    )
    profile.add_argument(
        "--output", default=None,
        help="report path (default {output.root_dir}/profile_{run.name}/profile_report.json)",
    )
    profile.add_argument("--json", action="store_true",
                         help="print the full report JSON to stdout")

    goodput = sub.add_parser(
        "goodput",
        help="render the wall-clock goodput ledger for any past run from its durable "
        "artifacts alone (telemetry/goodput.py)",
    )
    goodput.add_argument(
        "--run-dir", required=True,
        help="run directory holding telemetry/timeline.jsonl (+ optional checkpoints/ "
        "and heartbeat)",
    )
    goodput.add_argument("--json", action="store_true", help="emit the ledger as JSON")

    trace = sub.add_parser(
        "trace",
        help="merge per-process fleet timelines and rebuild cross-process "
        "request traces (telemetry/trace_collect.py)",
    )
    trace.add_argument(
        "action", choices=("slowest", "show", "summary", "merge"),
        help="slowest: top-k traces by end-to-end latency; show: span tree + "
        "critical-path breakdown of one trace; summary: per-span-kind "
        "p50/p95/p99; merge: one Perfetto trace (track group per process, flow "
        "arrows across the router→replica hop)",
    )
    trace.add_argument(
        "trace_id", nargs="?", default=None,
        help="trace id (or unique prefix) for 'show' — from `trace slowest`, a "
        "response payload, or a /metrics exemplar",
    )
    trace.add_argument(
        "--run-dir", action="append", required=True, dest="run_dirs",
        help="directory (scanned recursively for *timeline*.jsonl) or a single "
        "timeline file; repeatable — pass every fleet process's dir to stitch "
        "the cross-process tree together",
    )
    trace.add_argument("--k", type=int, default=10, help="how many traces 'slowest' lists")
    trace.add_argument(
        "--out", default=None,
        help="output path for 'merge' (default: merged_trace.json under the "
        "first --run-dir; open it in ui.perfetto.dev)",
    )
    trace.add_argument("--json", action="store_true", help="emit machine-readable JSON")

    evalp = sub.add_parser("eval", help="run the validation loop on a checkpoint, no training")
    evalp.add_argument("--config", required=True, help="path to the YAML run config")
    evalp.add_argument(
        "--from", dest="from_spec", default=None,
        help="checkpoint file, checkpoint dir, or run id to evaluate "
        "(default: the freshly initialized model)",
    )
    evalp.add_argument("--ema", action="store_true",
                       help="evaluate the EMA shadow weights tracked by "
                       "trainer.extra.ema_decay (errors if the checkpoint has none)")
    evalp.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="evaluate under weight-only int8 quantization (ops/quant.py): the "
        "quality cost of the quantized serving path on the validation split",
    )
    evalp.add_argument("--json", action="store_true", help="emit metrics as JSON")
    evalp.add_argument("-v", "--verbose", action="store_true", help="DEBUG logging")

    traintok = sub.add_parser(
        "train-tokenizer", help="train an offline byte-level BPE vocabulary on local text"
    )
    traintok.add_argument(
        "--input", required=True, action="append",
        help="text file or directory (repeatable); directories are read "
        "recursively for *.txt/*.md/*.py files",
    )
    traintok.add_argument("--vocab-size", type=int, default=8192)
    traintok.add_argument("--output", required=True, help="vocabulary JSON path")
    traintok.add_argument(
        "--max-bytes", type=int, default=64_000_000, help="cap on corpus bytes read for training"
    )
    traintok.add_argument("--json", action="store_true", help="emit stats as JSON")

    export = sub.add_parser(
        "export-checkpoint",
        help="export checkpoint weights as a torch state dict (gpt → reference GPT names, "
        "llama family → HF Llama names)",
    )
    export.add_argument("--config", required=True, help="path to the YAML run config")
    export.add_argument(
        "--from", dest="from_spec", required=True,
        help="checkpoint file, checkpoint dir, or run id to export",
    )
    export.add_argument("--output", required=True, help="output .pt path")
    export.add_argument("--ema", action="store_true",
                        help="export the EMA shadow weights tracked by "
                        "trainer.extra.ema_decay (errors if the checkpoint has none)")
    export.add_argument("--json", action="store_true", help="emit stats as JSON")

    imp = sub.add_parser(
        "import-checkpoint",
        help="build a resumable checkpoint from a torch state dict (gpt ← reference GPT names, "
        "llama family ← HF Llama names)",
    )
    imp.add_argument("--config", required=True, help="path to the YAML run config")
    imp.add_argument("--input", required=True, help="torch .pt state-dict path")
    imp.add_argument(
        "--output", required=True,
        help="checkpoint directory to write step_000000.ckpt into (use with train --resume <dir>)",
    )
    imp.add_argument("--json", action="store_true", help="emit stats as JSON")

    avg = sub.add_parser(
        "average-checkpoints",
        help="average the params of several checkpoints (model soup) into a "
        "resumable step-0 checkpoint",
    )
    avg.add_argument("--config", required=True, help="path to the YAML run config")
    avg.add_argument(
        "--inputs", required=True,
        help="comma-separated checkpoint files/dirs/run-ids (each resolved like "
        "--resume), OR one checkpoint dir with --last-k",
    )
    avg.add_argument(
        "--last-k", type=int, default=0,
        help="average the last K step_*.ckpt files of the single --inputs dir",
    )
    avg.add_argument(
        "--output", required=True,
        help="empty checkpoint directory to write step_000000.ckpt into",
    )
    avg.add_argument("--json", action="store_true", help="emit stats as JSON")

    chaos = sub.add_parser(
        "chaos",
        help="seeded chaos-recovery drill: repeated SIGKILL/resume cycles "
        "with crash-consistency invariants checked after every cycle "
        "(resilience/chaos.py)",
    )
    chaos.add_argument("--config", required=True, help="path to the YAML run config")
    chaos.add_argument(
        "--cycles", type=int, default=5,
        help="number of killed segments before the final uninterrupted one",
    )
    chaos.add_argument("--seed", type=int, default=0, help="seed for the kill-step schedule")
    chaos.add_argument(
        "--max-steps", type=int, default=None,
        help="override trainer.max_steps for the drill (keep it small)",
    )
    chaos.add_argument(
        "--save-every", type=int, default=None,
        help="override trainer.save_every_steps for the drill",
    )
    chaos.add_argument(
        "--work-dir", default=None,
        help="harness working directory (default: {output.root_dir}/chaos_{run.name}_s{seed})",
    )
    chaos.add_argument("--timeout-sec", type=float, default=600.0,
                       help="per-segment wall-clock budget")
    chaos.add_argument("--json", action="store_true", help="emit the result as JSON")

    plan = sub.add_parser(
        "plan",
        help="dry-run the mesh planner: resolve the config's MeshPlan, "
        "predict its roofline class and per-device memory, run nothing "
        "(autotune/plan.py; exit 2 on an infeasible plan)",
    )
    plan.add_argument("--config", required=True, help="path to the YAML run config")
    plan.add_argument(
        "--devices", type=int, default=None,
        help="plan against this many devices instead of the locally visible count",
    )
    plan.add_argument("--json", action="store_true", help="emit the plan as JSON")

    tune = sub.add_parser(
        "tune",
        help="auto-tune mesh shape x microbatch x activation tiers x zero stage: "
        "analytic roofline/memory pruning, then short probe fits scored by "
        "measured MFU; emits the winner as a loadable config (autotune/)",
    )
    tune.add_argument("--config", required=True, help="path to the YAML run config")
    tune.add_argument(
        "--output", default=None,
        help="emitted config path (default {output.root_dir}/tune_{run.name}/tuned.yaml)",
    )
    tune.add_argument(
        "--workdir", default=None,
        help="probe-run scratch dir (default {output.root_dir}/tune_{run.name})",
    )
    tune.add_argument("--json", action="store_true", help="print the full tune report JSON")

    promote = sub.add_parser(
        "promote",
        help="continuous train→canary→promote lifecycle: watch a training "
        "run's manifest stream, canary each new commit on one replica, "
        "score it (eval loss + TTFT/per-token SLO soak), then promote "
        "fleet-wide or auto-roll-back (lifecycle/, docs/robustness.md "
        "'Canary, promote, rollback')",
    )
    promote.add_argument(
        "--config", required=True, help="path to the YAML run config"
    )
    promote.add_argument(
        "--watch",
        required=True,
        help="training run dir (or its checkpoints/ dir) whose manifest "
        "stream to watch; promotions.jsonl is written next to the run's "
        "other durable artifacts",
    )
    promote.add_argument(
        "--from",
        dest="from_spec",
        default=None,
        help="initial baseline checkpoint to serve (default: the last "
        "promoted entry in promotions.jsonl, else the stream's newest "
        "commit — promote waits for the first one if needed)",
    )
    promote.add_argument(
        "--replicas",
        type=int,
        default=None,
        help="in-process fleet size (default: serving.router.replicas)",
    )
    promote.add_argument(
        "--max-promotions",
        type=int,
        default=None,
        help="stop after this many promotions (default: promote.max_promotions; "
        "0 = run until the stream ends)",
    )
    promote.add_argument(
        "--idle-timeout-sec",
        type=float,
        default=None,
        help="exit after this long with no new commit and no training "
        "heartbeat (default: promote.idle_timeout_sec)",
    )
    promote.add_argument(
        "--no-eval",
        action="store_true",
        help="skip the held-out eval-loss gate (soak/SLO gates still run)",
    )
    promote.add_argument("--json", action="store_true", help="emit the result as JSON")
    # Decode-stack flags shared with serve's loaders (promote keeps the
    # defaults; the flags exist so _load_decode_params is reused as-is).
    promote.set_defaults(
        draft_config=None,
        draft_from=None,
        gamma=None,
        backends=None,
        discover=None,
        decode_param_dtype="compute",
        quantize="none",
        ema=False,
        mode="continuous",
        router=True,
    )

    fleet = sub.add_parser(
        "fleet",
        help="multi-tenant fleet supervisor: schedule fleet.tenants onto a "
        "bounded pool of ranks (CPU or card) with preemption-aware scheduling, "
        "quotas, and the SIGTERM->SIGKILL escalation ladder (fleet/, "
        "docs/robustness.md)",
    )
    fleet.add_argument("--config", required=True, help="path to the YAML run config")
    fleet.add_argument(
        "--storm",
        action="store_true",
        help="run the seeded preemption-storm acceptance drill instead of "
        "a plain fleet run: capacity drop + seeded evictions + one "
        "mid-checkpoint kill, then per-tenant bitwise parity against "
        "uninterrupted references (fleet/chaos.py)",
    )
    fleet.add_argument(
        "--seed", type=int, default=0, help="seed for the storm schedule "
        "and the per-tenant respawn-backoff streams"
    )
    fleet.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="override trainer.max_steps for every tenant (keep it small)",
    )
    fleet.add_argument(
        "--save-every",
        type=int,
        default=None,
        help="override trainer.save_every_steps for every tenant",
    )
    fleet.add_argument(
        "--work-dir",
        default=None,
        help="supervisor working directory (default: "
        "{output.root_dir}/fleet_{run.name} or fleet_storm_{run.name}_s{seed})",
    )
    fleet.add_argument(
        "--timeout-sec",
        type=float,
        default=900.0,
        help="whole-fleet wall-clock budget",
    )
    fleet.add_argument(
        "--step-delay-sec",
        type=float,
        default=0.15,
        help="storm only: per-step tenant throttle so external evictions "
        "land mid-run (trainer.extra.step_delay_sec)",
    )
    fleet.add_argument(
        "--fresh",
        action="store_true",
        help="wipe the work dir's runs tree before starting (default: a "
        "restarted supervisor auto-resumes every tenant from its newest "
        "commit; --storm always starts fresh)",
    )
    fleet.add_argument("--json", action="store_true", help="emit the result as JSON")

    validate = sub.add_parser("validate", help="validate a config file")
    validate.add_argument("--config", required=True)
    validate.add_argument("--json", action="store_true")

    printcfg = sub.add_parser("print-config", help="print the resolved config")
    printcfg.add_argument("--config", required=True)
    printcfg.add_argument("--json", action="store_true")
    return parser


def _emit_error(message: str, *, details: Any = None, errors: Any = None) -> None:
    payload: dict[str, Any] = {"error": message}
    if details:
        payload["details"] = details
    if errors:
        payload["errors"] = errors
    print(json.dumps(payload), file=sys.stderr)


def _load_config(path: str):
    """(cfg, None) or (None, exit code) after printing the JSON error."""
    try:
        cfg, _, _ = load_and_validate_config(path)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return None, EXIT_CONFIG_ERROR
    return cfg, None


def _lora_spec_error(cfg) -> str | None:
    """A malformed ``model.extra.lora`` is a config error (exit 2), found
    before any model is built (JAX ``_lora_spec_error``)."""
    from .models.lora import lora_spec_error

    return lora_spec_error(cfg)


def _unported_inference_flags(args: argparse.Namespace, cfg) -> str | None:
    """Message for a malformed LoRA spec, or for unpaired draft flags
    (JAX's checks)."""
    lora = _lora_spec_error(cfg)
    if lora is None and (args.draft_config is None) != (args.draft_from is None):
        return "--draft-config and --draft-from must be given together"
    return lora


def _setup_distributed(cfg):
    """``distributed.enabled``: join the process group (JAX ``_handle_train``'s
    rendezvous), retried with full-jitter backoff seeded per (seed, rank).
    Returns ``(state, None)`` or ``(None, exit code)``: a topology that
    cannot work (``ValueError``) is 2, any other rendezvous failure (the
    coordinator not up, a timeout) 75, so the orchestrator restarts."""
    from .distributed import resolve_topology, setup_distributed
    from .resilience.exit_codes import EXIT_RETRYABLE_INFRA
    from .resilience.faults import FaultPlan, retry, retry_rng

    plan = FaultPlan.from_config(cfg.resilience.faults)
    try:
        rank_hint, _, _ = resolve_topology(cfg.distributed)
    except Exception:  # noqa: BLE001 — jitter seeding must not mask it
        rank_hint = 0
    try:
        state = retry(
            plan.flaky("distributed_init",
                       lambda: setup_distributed(cfg.distributed, cfg.run.device)),
            attempts=cfg.resilience.retry_attempts,
            base_delay=cfg.resilience.retry_base_delay,
            description="distributed init",
            rng=retry_rng(cfg.run.seed, rank_hint),
        )
    except ValueError as exc:
        _emit_error(f"distributed init failed: {exc}")
        return None, EXIT_CONFIG_ERROR
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"distributed init failed: {exc}")
        return None, EXIT_RETRYABLE_INFRA
    return state, None


def _agree_run_id(candidate: str, dist_state) -> str:
    """Rank 0's run id on every process (a generated id depends on the
    clock and the filesystem)."""
    if dist_state is None or dist_state.num_processes == 1:
        return candidate
    import torch.distributed as dist

    from .distributed import collective_errors

    box = [candidate]
    with collective_errors():
        dist.broadcast_object_list(box, src=0)
    return str(box[0])


def _agree_flag(local_ok: bool, dist_state) -> bool:
    """Rank 0's boolean on every process (one process: the identity)."""
    if dist_state is None or dist_state.num_processes == 1:
        return local_ok
    from .distributed import broadcast_int_from_main

    return bool(broadcast_int_from_main(1 if local_ok else 0))


def _handle_train(args: argparse.Namespace) -> int:
    """The JAX ``_handle_train``: the rendezvous when ``distributed.enabled``,
    then on rank 0 only the run dir, config copy and meta.json, logging,
    the trainer (every rank) or the dry run, and rank 0's summary."""
    from .distributed import teardown_distributed

    try:
        cfg, _, resolved = load_and_validate_config(args.config)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return EXIT_CONFIG_ERROR
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR
    dist_state = None
    if cfg.distributed.enabled:
        dist_state, code = _setup_distributed(cfg)
        if dist_state is None:
            return code
    try:
        return _train(args, cfg, resolved, dist_state)
    finally:
        teardown_distributed()


def _create_tracker(cfg, dist_state, run_id: str):
    """A real tracker on the main process when ``mlflow.enabled``, the null
    one otherwise (tracking/__init__.py ``build_tracker`` picks the
    backend: mlflow, the native SQLite store, or TensorBoard)."""
    from .tracking import NullTracker, build_tracker

    is_main = dist_state is None or dist_state.is_main
    if cfg.mlflow.enabled and is_main:
        return build_tracker(cfg.mlflow, run_id)
    return NullTracker()


def _log_run_artifacts(tracker, run_dir: Path | None) -> None:
    if run_dir is None:
        return
    for name in ("config.yaml", "meta.json"):
        path = run_dir / name
        if path.is_file():
            tracker.log_artifact(str(path))


def _train(args: argparse.Namespace, cfg, resolved, dist_state) -> int:
    """``train`` after the rendezvous: ``dist_state`` is the group's state,
    or None without ``distributed.enabled``. The tracker runs from
    ``start_run`` to ``end_run``, which reads FINISHED or FAILED."""
    from .registry import RegistryError, get_data_module, get_model_adapter, initialize_registries
    from .tracking import NullTracker
    from .utils.logging import configure_logging, get_logger
    from .utils.metadata import generate_meta, write_meta_json
    from .utils.run_dir import create_run_directory, write_resolved_config
    from .utils.run_id import generate_run_id
    from .utils.summary import format_run_summary

    is_main = dist_state is None or dist_state.is_main
    logger = get_logger()
    tracker = NullTracker()
    tracker_started = False
    exit_code = EXIT_FAILURE
    try:
        run_id = args.run_id or cfg.output.run_id
        if args.auto_resume and run_id is None:
            _emit_error(
                "--auto-resume requires a stable run id (--run-id or output.run_id): "
                "a generated id is fresh on every restart"
            )
            return EXIT_CONFIG_ERROR
        if run_id is None:
            run_id = generate_run_id(cfg.run.name, cfg.output.root_dir)
        run_id = _agree_run_id(run_id, dist_state)
        # Rank-0-only I/O; every rank agrees on the outcome, or the others
        # would run on into the first collective and hang.
        run_dir: Path | None = None
        run_dir_ok = True
        resuming_existing = False
        if is_main:
            try:
                run_dir = create_run_directory(cfg.output.root_dir, run_id)
            except FileExistsError:
                if args.auto_resume:
                    from .training.checkpoint import CheckpointManager

                    run_dir = Path(cfg.output.root_dir) / run_id
                    (run_dir / "logs").mkdir(parents=True, exist_ok=True)
                    resuming_existing = (
                        CheckpointManager(run_dir / "checkpoints").latest_checkpoint()
                        is not None
                    )
                else:
                    run_dir_ok = False
        if not _agree_flag(run_dir_ok, dist_state):
            if is_main:
                _emit_error(
                    f"run directory already exists for run id {run_id!r}",
                    details="pass a fresh --run-id or let the run id be generated",
                )
            return EXIT_FAILURE
        resume_spec = args.resume
        if _agree_flag(resuming_existing, dist_state):
            resume_spec = str(Path(cfg.output.root_dir) / run_id / "checkpoints")

        log_file = None
        if cfg.logging.log_to_file and run_dir is not None:
            log_file = run_dir / "logs" / cfg.logging.file_name
        level = "DEBUG" if args.verbose else cfg.logging.level
        configure_logging(level=level, json_output=cfg.logging.json_output, log_file=log_file)
        if run_dir is not None and cfg.output.save_config_copy:
            write_resolved_config(run_dir, resolved)
        if run_dir is not None and cfg.output.save_meta_json:
            meta = generate_meta(
                run_id=run_id, run_name=cfg.run.name, config_path=args.config,
                resolved_config_path=run_dir / "config.yaml",
            )
            write_meta_json(run_dir, meta)

        initialize_registries()
        _warn_unknown_extras(cfg)
        try:
            get_model_adapter(cfg.model.name)
            get_data_module(cfg.data.name)
        except RegistryError as exc:
            _emit_error(str(exc))
            return EXIT_CONFIG_ERROR

        tracker = _create_tracker(cfg, dist_state, run_id)
        tracker.start_run(run_id, cfg.mlflow.run_name)
        tracker_started = True

        run_dir_text = str(run_dir) if run_dir is not None else None
        if args.dry_run:
            from .training.dry_run import run_dry_run

            summary = format_run_summary(
                cfg, run_id=run_id, run_dir=run_dir_text, dry_run=True,
                dry_run_result=run_dry_run(cfg), as_json=args.json,
            )
        else:
            from .training.trainer import Trainer

            # Every rank gets the run dir's path (reads only; writes stay
            # rank 0's inside the trainer).
            trainer_run_dir = run_dir
            if run_dir is None and dist_state is not None and dist_state.num_processes > 1:
                trainer_run_dir = Path(cfg.output.root_dir) / run_id
            result = Trainer(cfg, trainer_run_dir, tracker).fit(resume_from=resume_spec)
            summary = format_run_summary(
                cfg, run_id=run_id, run_dir=run_dir_text, dry_run=False,
                train_result=result, as_json=args.json,
            )
        if is_main:
            print(json.dumps(summary) if args.json else summary)
            _log_run_artifacts(tracker, run_dir)
        exit_code = EXIT_OK
        return exit_code
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        exit_code = exit_code_for_exception(exc)
        logger.exception("training failed: %s", exc)
        _emit_error(f"training failed: {exc} (exit {exit_code})")
        return exit_code
    finally:
        if tracker_started:
            tracker.end_run("FINISHED" if exit_code == EXIT_OK else "FAILED")


def _build_decode_stack(cfg, device, logger):
    """Adapter + (optional) tokenizer + model on ``device`` (a LoRA config
    builds its LoraModel, merged on load)."""
    from .models.lora import build_adapter

    adapter = build_adapter(cfg)
    tokenizer = None
    try:
        tokenizer = adapter.build_tokenizer(cfg)
    except Exception as exc:  # noqa: BLE001 — offline environments: tokenizer optional
        logger.warning("build_tokenizer failed (%s); continuing without one", exc)
    try:
        model = adapter.build_model(cfg, device)
    except NotImplementedError:
        raise
    except Exception:
        if cfg.model.vocab_size is None and tokenizer is None:
            raise ValueError(
                "building the model needs a vocab size but no tokenizer is "
                "available; set model.vocab_size explicitly in the config"
            ) from None
        raise
    return adapter, tokenizer, model


def prepare_decode_model(model, decode_param_dtype: str, logger):
    """``--decode-param-dtype compute`` casts floating params to the model
    compute dtype (a bf16-compute model then streams half the weight bytes
    per token), as the JAX CLI does at load time."""
    if decode_param_dtype == "compute" and model.dtype != model.param_dtype:
        model = model.to(model.dtype)
        model.param_dtype = model.dtype
        logger.info(
            "cast floating params to %s for decode (--decode-param-dtype param "
            "keeps the checkpoint's master precision)",
            str(model.dtype).replace("torch.", ""),
        )
    return model


def _load_decode_params(cfg, model, from_spec: str, decode_param_dtype: str, logger,
                        *, quantize: str = "none", label: str = "", ema: bool = False):
    """Checkpoint → decode-ready model, the shared load tail of generate (and
    its draft), serve and serve-bench: resolve the spec, load the params
    (``ema``: the EMA shadow; warning on a config mismatch), cast for
    decode, and with ``quantize`` int8 quantize the weights in place
    (ops/quant.py)."""
    import yaml

    from .models.lora import to_inference_model
    from .training.checkpoint import load_ema_params, load_inference_params, resolve_resume_path

    ckpt_path = resolve_resume_path(from_spec, cfg.output.root_dir)
    expected_yaml = yaml.safe_dump(cfg.model_dump(), sort_keys=False)
    if getattr(model, "stacks_layers", False):
        # A pipeline run decodes through the plain GPT with its weights
        # (interop/pipeline_convert.py: same math), which has the KV cache;
        # the window and the decode-cache dtype carry over.
        model = model.to_gpt()
        logger.info("%spipeline checkpoint converted to the gpt tree for KV-cache decoding",
                    label)
    load = load_ema_params if ema else load_inference_params
    step = load(ckpt_path, model, expected_config_yaml=expected_yaml)
    logger.info("%sloaded checkpoint %s (step %d)", label, ckpt_path, step)
    # A LoRA run decodes its merged weights (models/lora.py).
    model = prepare_decode_model(to_inference_model(model), decode_param_dtype, logger)
    if quantize == "int8":
        from .ops.quant import quantize_model

        stats = quantize_model(model)
        logger.info(
            "%sint8 weight quantization: %d/%d params quantized, "
            "%.2fx weight-byte compression",
            label, stats["quantized_params"], stats["total_params"], stats["compression"],
        )
    return model, ckpt_path, step


def _load_draft(draft_cfg, args: argparse.Namespace, model, device, logger):
    """The draft model of ``--draft-config/--draft-from``, through the same
    load tail as the target (``--quantize`` applies to it too). Raises
    ValueError when its vocabulary is not the target's."""
    lora = _lora_spec_error(draft_cfg)
    if lora is not None:
        raise NotImplementedError(lora)
    _, _, draft_model = _build_decode_stack(draft_cfg, device, logger)
    draft_model, _, _ = _load_decode_params(
        draft_cfg, draft_model, args.draft_from, args.decode_param_dtype, logger,
        quantize=args.quantize, label="draft ",
    )
    if draft_model.vocab_size != model.vocab_size:
        raise ValueError(
            f"draft vocab_size ({draft_model.vocab_size}) != target "
            f"vocab_size ({model.vocab_size}) — speculative decoding "
            "needs a shared vocabulary"
        )
    return draft_model


def _group_seed(seed: int, *keys: int) -> int:
    """A distinct, reproducible generator seed per prompt-length group (and
    per row under speculative decoding): the JAX CLI folds them into its
    key."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, *keys]).generate_state(1, np.uint64)[0])


def _handle_generate(args: argparse.Namespace) -> int:
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_inference_flags(args, cfg)
    if unported is None and args.draft_config is not None and args.gamma < 1:
        unported = f"--gamma must be >= 1, got {args.gamma}"
    if unported is None and args.draft_config is not None and args.logprobs:
        unported = "--logprobs is not supported with speculative decoding"
    if unported is not None:
        _emit_error(unported)
        return EXIT_CONFIG_ERROR

    file_prompts: list[str] | None = None
    if args.prompts_file is not None:
        try:
            lines = Path(args.prompts_file).read_text(encoding="utf-8").splitlines()
        except OSError as exc:
            _emit_error(f"cannot read --prompts-file: {exc}")
            return EXIT_FAILURE
        file_prompts = [ln for ln in lines if ln.strip()]
        if not file_prompts:
            _emit_error(f"{args.prompts_file}: no non-empty prompt lines")
            return EXIT_FAILURE

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    try:
        import torch

        from .distributed import resolve_device
        from .generation import generate
        from .speculative import speculative_generate

        device = resolve_device(cfg.run.device)
        _, tokenizer, model = _build_decode_stack(cfg, device, logger)
        prompts: list[str] | None = None
        if args.prompt_ids is not None:
            prompt_batches = [
                np.asarray([int(t) for t in args.prompt_ids.split(",") if t.strip()], np.int32)
            ]
        else:
            if tokenizer is None:
                _emit_error(
                    "no tokenizer available for --prompt/--prompts-file; "
                    "pass --prompt-ids instead"
                )
                return EXIT_FAILURE
            prompts = file_prompts if file_prompts is not None else [args.prompt]
            prompt_batches = [np.asarray(tokenizer.encode(p), np.int32) for p in prompts]
        if any(ids.size == 0 for ids in prompt_batches):
            _emit_error("every prompt must contain at least one token")
            return EXIT_FAILURE
        # Fail fast on a prompt that cannot fit the speculative buffer, before
        # the checkpoint I/O of each model.
        need = max(len(ids) for ids in prompt_batches) + args.max_new_tokens + args.gamma + 1

        def too_long(label: str, block_size: int) -> bool:
            if need <= block_size:
                return False
            _emit_error(f"prompt+max_new_tokens+gamma ({need}) exceeds the "
                        f"{label} model's block_size ({block_size})")
            return True

        if args.draft_config is not None and too_long("target", cfg.model.block_size):
            return EXIT_CONFIG_ERROR
        model, ckpt_path, step = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger, quantize=args.quantize,
            ema=args.ema,
        )
        draft_model = None
        if args.draft_config is not None:
            try:
                draft_cfg, _, _ = load_and_validate_config(args.draft_config)
            except ConfigLoadError as exc:
                _emit_error(exc.message, details=exc.details, errors=exc.errors)
                return EXIT_CONFIG_ERROR
            if too_long("draft", draft_cfg.model.block_size):
                return EXIT_CONFIG_ERROR
            try:
                draft_model = _load_draft(draft_cfg, args, model, device, logger)
            except ValueError as exc:
                _emit_error(str(exc))
                return EXIT_CONFIG_ERROR
        eos_token_id = args.eos_token_id
        if eos_token_id is None and tokenizer is not None:
            eos_token_id = getattr(tokenizer, "eot_token", None)

        # Equal-length prompts share one rectangular batch.
        by_len: dict[int, list[int]] = {}
        for i, ids in enumerate(prompt_batches):
            by_len.setdefault(len(ids), []).append(i)
        results: list[dict] = [{} for _ in prompt_batches]
        for tp, idxs in sorted(by_len.items()):
            stacked = np.stack([prompt_batches[i] for i in idxs])
            generator = torch.Generator(device=device)
            generator.manual_seed(_group_seed(args.seed, tp))
            if draft_model is not None:
                # speculative_generate is batch 1: the group's rows one at a
                # time, each with its own stream.
                rows = []
                for row in range(stacked.shape[0]):
                    generator.manual_seed(_group_seed(args.seed, tp, row))
                    rows.append(speculative_generate(
                        model, draft_model, stacked[row:row + 1],
                        max_new_tokens=args.max_new_tokens,
                        gamma=args.gamma,
                        temperature=args.temperature,
                        top_k=args.top_k,  # <=0 and out-of-band top_p disable
                        top_p=args.top_p,
                        eos_token_id=eos_token_id,
                        generator=generator,
                    ))
                out, group_lps = np.concatenate(rows, axis=0), None
            else:
                gen_out = generate(
                    model,
                    stacked,
                    max_new_tokens=args.max_new_tokens,
                    generator=generator,
                    temperature=args.temperature,
                    top_k=args.top_k,  # generate() maps <=0 to "disabled"
                    top_p=args.top_p,
                    eos_token_id=eos_token_id,
                    return_logprobs=args.logprobs,
                )
                out, group_lps = gen_out if args.logprobs else (gen_out, None)
            for row, i in enumerate(idxs):
                output_ids = [int(t) for t in out[row]]
                results[i] = {
                    "prompt_ids": [int(t) for t in prompt_batches[i]],
                    "completion_ids": output_ids[tp:],
                    "output_ids": output_ids,
                    "text": tokenizer.decode(output_ids) if tokenizer is not None else None,
                }
                if group_lps is not None:
                    results[i]["logprobs"] = [round(float(x), 6) for x in group_lps[row]]
                if prompts is not None:
                    results[i]["prompt"] = prompts[i]

        if args.json:
            payload: dict[str, Any] = {"checkpoint": str(ckpt_path), "step": step}
            if args.prompts_file is not None:
                payload["results"] = results
            else:
                payload.update(results[0])
            print(json.dumps(payload))
        else:
            rendered = [
                r["text"] if r["text"] is not None else " ".join(str(t) for t in r["output_ids"])
                for r in results
            ]
            print("\n\n---\n\n".join(rendered))
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        logger.exception("generation failed: %s", exc)
        _emit_error(f"generation failed: {exc}")
        return exit_code_for_exception(exc)
    return EXIT_OK


def _build_serving_backend(cfg, model, logger, args: argparse.Namespace | None = None,
                           registry=None, trace_dir=None, name=None):
    """Continuous-batching scheduler + metrics registry for serve and
    serve-bench (JAX ``_build_serving_backend``).

    Policy resolution: ``--draft-config`` forces ``speculative`` (the
    config may select it too, and then the draft flags are required);
    otherwise ``serving.policy``. The speculative policy drafts and
    verifies in batch on two engines (target and draft) when both models
    decode paged, else serves batch 1. Raises ValueError with the
    actionable message on a bad combination (exit 2), ConfigLoadError for
    a bad draft config. ``args`` carries the draft and quantize flags (none
    given when it is None).

    With ``telemetry.enabled`` and ``telemetry.timeline`` the scheduler gets
    an event timeline — memory-only, or file-backed at
    ``{trace_dir}/{name}/timeline.jsonl`` when ``trace_dir`` is given, for
    ``trace`` to merge — and a request tracer (``telemetry.tracing``)."""
    from .serving import ContinuousBatchingScheduler, OverloadController, PagedDecodeEngine
    from .telemetry.registry import MetricsRegistry
    from .telemetry.timeline import EventTimeline

    scfg = cfg.serving
    if registry is None:
        registry = MetricsRegistry()
    timeline = None
    if cfg.telemetry.enabled and cfg.telemetry.timeline:
        tl_path = (
            Path(trace_dir) / (name or "serve") / "timeline.jsonl"
            if trace_dir is not None else None
        )
        timeline = EventTimeline(
            tl_path,
            max_events=cfg.telemetry.max_events,
            xprof_annotations=cfg.telemetry.xprof_annotations,
        )
    overload = None
    if scfg.overload.enabled:
        overload = OverloadController.from_config(scfg.overload)
        logger.info(
            "overload control: queue_cap %d, classes %s, brownout %.0f/%.0f ms",
            scfg.overload.queue_cap,
            dict(scfg.overload.classes),
            scfg.overload.brownout_high_ms,
            scfg.overload.brownout_low_ms,
        )
    engine_kwargs = dict(
        block_tokens=scfg.block_tokens,
        num_blocks=scfg.num_blocks or None,
        max_batch_slots=scfg.max_batch_slots,
        prompt_buckets=scfg.prompt_buckets or None,
        batch_buckets=scfg.batch_buckets or None,
    )
    draft_config = getattr(args, "draft_config", None)
    policy = "speculative" if draft_config is not None else scfg.policy
    if policy == "speculative":
        if draft_config is None or args.draft_from is None:
            raise ValueError(
                "the speculative serving policy needs --draft-config AND "
                "--draft-from (serving.policy: speculative in the config "
                "selects it; the draft checkpoint must come from the CLI)"
            )
        draft_cfg, _, _ = load_and_validate_config(draft_config)
        draft_model = _load_draft(draft_cfg, args, model, model.token_embedding.weight.device,
                                  logger)
        engine = draft_engine = None
        if hasattr(model, "for_paged_decoding") and hasattr(draft_model, "for_paged_decoding"):
            engine = PagedDecodeEngine(model, **engine_kwargs)
            draft_engine = PagedDecodeEngine(draft_model, **engine_kwargs)
            logger.info(
                "batched speculative serving: %d slots, gamma from %s",
                engine.max_batch_slots, "--gamma" if args.gamma is not None else "config",
            )
        scheduler = ContinuousBatchingScheduler(
            engine,
            policy="speculative",
            registry=registry,
            model=model,
            draft_model=draft_model,
            draft_engine=draft_engine,
            gamma=args.gamma if args.gamma is not None else scfg.speculative_gamma,
            timeline=timeline,
            overload=overload,
        )
        _configure_request_tracer(cfg, scheduler, timeline)
        return scheduler, registry
    engine = PagedDecodeEngine(
        model, **engine_kwargs, prefix_cache=scfg.prefix_cache, prefill_chunk=scfg.prefill_chunk
    )
    logger.info(
        "continuous batching: %d slots, %d-token blocks x %d pool blocks, "
        "prompt buckets %s, batch buckets %s",
        engine.max_batch_slots,
        engine.block_tokens,
        engine.pool.num_blocks,
        engine.prompt_buckets,
        engine.batch_buckets,
    )
    scheduler = ContinuousBatchingScheduler(
        engine, registry=registry, timeline=timeline, overload=overload
    )
    _configure_request_tracer(cfg, scheduler, timeline)
    return scheduler, registry


def _configure_request_tracer(cfg, backend, timeline) -> None:
    """Replace a scheduler's or router's default request tracer with one
    built from ``telemetry.tracing`` (tail-sampling knobs), or strip it when
    tracing is disabled: the backends default to a tracer whenever they have
    a timeline, so the config gate is applied here."""
    tcfg = cfg.telemetry.tracing
    if timeline is None or not tcfg.enabled:
        backend.tracer = None
        return
    from .telemetry.tracing import TailSampler, Tracer

    backend.tracer = Tracer(
        timeline,
        sampler=TailSampler(
            slow_frac=tcfg.slow_keep_frac,
            reservoir=tcfg.reservoir,
            warmup=tcfg.warmup_keep,
        ),
        max_spans=tcfg.max_spans_per_trace,
    )


def _build_router_backend(cfg, model, logger, args: argparse.Namespace, trace_dir=None):
    """Replica-router tier for ``serve --router`` / ``serve-bench --router``
    (JAX ``_build_router_backend``).

    Default: ``serving.router.replicas`` (or ``--replicas``) in-process
    replicas, each a scheduler + engine with its own step thread, all
    decoding the one ``model`` on the card. ``--backends``/``--discover``
    route across separate serve processes over HTTP instead."""
    from .serving import HTTPReplica, InProcessReplica, ReplicaRouter, resolve_backends
    from .telemetry.registry import MetricsRegistry

    rcfg = cfg.serving.router
    registry = MetricsRegistry()
    replicas: list[Any] = []
    urls: list[str] = []
    if getattr(args, "backends", None):
        urls = [u.strip() for u in args.backends.split(",") if u.strip()]
        if not urls:
            raise ValueError("--backends must list at least one base URL")
    elif getattr(args, "discover", None):
        urls = resolve_backends(args.discover)
    if urls:
        replicas = [
            HTTPReplica(u, timeout_sec=cfg.serving.request_timeout_sec,
                        probe_timeout_sec=rcfg.probe_timeout_sec)
            for u in urls
        ]
    else:
        n = getattr(args, "replicas", None) or rcfg.replicas
        for i in range(n):
            # In-process replicas share the router's registry so the
            # scheduler-level overload series reach the fleet /metrics
            # scrape; counters sum across replicas, gauges are
            # last-writer-wins.
            sched, _ = _build_serving_backend(
                cfg, model, logger, args, registry=registry, trace_dir=trace_dir,
                name=f"replica{i}",
            )
            sched.start()
            replicas.append(InProcessReplica(sched, f"replica{i}"))
    # The router's own timeline: its placement/failover/hop spans land in a
    # separate JSONL track (`{trace_dir}/router/`) that `trace` stitches to
    # the replica tracks via traceparent.
    router_timeline = None
    if cfg.telemetry.enabled and cfg.telemetry.timeline:
        from .telemetry.timeline import EventTimeline

        router_timeline = EventTimeline(
            Path(trace_dir) / "router" / "timeline.jsonl" if trace_dir is not None else None,
            max_events=cfg.telemetry.max_events,
            xprof_annotations=False,
        )
    router = ReplicaRouter(
        replicas,
        registry=registry,
        affinity_weight=rcfg.affinity_weight,
        max_affinity_entries=rcfg.max_affinity_entries,
        fail_threshold=rcfg.fail_threshold,
        revive_sec=rcfg.revive_sec,
        block_tokens=cfg.serving.block_tokens,
        retry_budget=rcfg.retry_budget,
        retry_window_sec=rcfg.retry_window_sec,
        timeline=router_timeline,
    )
    _configure_request_tracer(cfg, router, router_timeline)
    logger.info(
        "replica router: %d %s replicas, affinity_weight %.1f, fail_threshold %d",
        len(replicas),
        "HTTP" if isinstance(replicas[0], HTTPReplica) else "in-process",
        rcfg.affinity_weight,
        rcfg.fail_threshold,
    )
    return router, registry


def _handle_serve(args: argparse.Namespace) -> int:
    """Checkpoint → HTTP server (serving/). ``serving.mode: continuous``
    (or ``--mode continuous``) swaps the one-decode-at-a-time device lock
    for the paged-KV continuous-batching scheduler: handler threads submit
    into the admission queue and in-flight sequences share each decode
    step; ``POST /reload`` hot-swaps a checkpoint under live traffic. With
    ``--router``/``--backends``/``--discover`` a replica router takes the
    scheduler's seat and ``POST /reload`` rolls one replica at a time. As in
    JAX, the router process loads the model too (its HTTP layer validates
    requests against it)."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_inference_flags(args, cfg)
    if unported is not None:
        _emit_error(unported)
        return EXIT_CONFIG_ERROR
    mode = args.mode or cfg.serving.mode
    if mode != "continuous" and args.draft_config is not None:
        # Ignoring the draft flags would serve plain single-request decode
        # while the user asked for speculative.
        _emit_error(
            "--draft-config/--draft-from need the continuous backend; "
            "set serving.mode: continuous (or pass --mode continuous)"
        )
        return EXIT_CONFIG_ERROR
    if args.backends and args.discover:
        _emit_error("--backends and --discover are mutually exclusive")
        return EXIT_CONFIG_ERROR
    use_router = bool(args.router or args.backends or args.discover)
    if use_router and mode != "continuous":
        _emit_error(
            "--router needs the continuous backend; set serving.mode: "
            "continuous (or pass --mode continuous)"
        )
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    scheduler = None
    metrics_stop = None
    metrics_thread = None
    try:
        from .distributed import resolve_device
        from .serving import ClientRateGate, ServerState, make_server
        from .telemetry.registry import MetricsRegistry

        device = resolve_device(cfg.run.device)
        _, tokenizer, model = _build_decode_stack(cfg, device, logger)
        model, ckpt_path, step = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger, quantize=args.quantize,
            ema=args.ema,
        )
        eos = args.eos_token_id
        if eos is None and tokenizer is not None:
            eos = getattr(tokenizer, "eot_token", None)
        if mode == "continuous":
            try:
                if use_router:
                    scheduler, registry = _build_router_backend(
                        cfg, model, logger, args, trace_dir=args.trace_dir
                    )
                else:
                    scheduler, registry = _build_serving_backend(
                        cfg, model, logger, args, trace_dir=args.trace_dir
                    )
            except ConfigLoadError as exc:
                _emit_error(exc.message, details=exc.details, errors=exc.errors)
                return EXIT_CONFIG_ERROR
            except ValueError as exc:
                _emit_error(str(exc))
                return EXIT_CONFIG_ERROR
            scheduler.start()
        else:
            # Simple mode still serves GET /metrics (request counter and
            # latency from ServerStats).
            registry = MetricsRegistry()
        cap = (
            args.max_new_tokens_cap
            if args.max_new_tokens_cap is not None
            else cfg.serving.max_new_tokens_cap
        )
        client_gate = None
        ocfg = cfg.serving.overload
        if ocfg.enabled and ocfg.client_rate_rps > 0:
            client_gate = ClientRateGate(
                ocfg.client_rate_rps, ocfg.client_burst, max_clients=ocfg.max_tracked_clients
            )
        state = ServerState(
            model=model,
            tokenizer=tokenizer,
            step=step,
            checkpoint=str(ckpt_path),
            eos_token_id=eos,
            max_new_tokens_cap=cap,
            default_max_new_tokens=cfg.serving.default_max_new_tokens,
            scheduler=scheduler,
            registry=registry,
            request_timeout_sec=cfg.serving.request_timeout_sec,
            liveness_stale_sec=cfg.serving.liveness_stale_sec,
            client_gate=client_gate,
        )

        if scheduler is not None:
            # Zero-downtime checkpoint hot swap: POST /reload re-resolves
            # the --from spec (a dir or run id resolves to the NEWEST
            # checkpoint) into ONE new target model (a copy of the serving
            # one, already on the device and in the decode dtype, its
            # weights restored from their codes when quantized) and swaps it
            # in without dropping a request — in-flight sequences finish
            # on the model they were admitted under, new admissions use
            # the new one. With a router the new model rolls through the
            # replicas one at a time; the live module is never loaded into,
            # since older epochs still decode on it. A draft keeps its weights.
            def _reload(body: dict) -> dict:
                import copy

                from .ops.quant import dequantize_model

                before = _device_memory_gib(device)
                spec = str(body.get("from") or args.from_spec)
                new_model, new_ckpt, new_step = _load_decode_params(
                    cfg, dequantize_model(copy.deepcopy(state.model)), spec,
                    args.decode_param_dtype, logger, quantize=args.quantize, label="reload ",
                    ema=args.ema,
                )
                out: dict[str, Any] = {"step": new_step, "checkpoint": str(new_ckpt)}
                if hasattr(scheduler, "rolling_reload"):
                    out["replicas"] = scheduler.rolling_reload(
                        params=new_model, step=new_step, checkpoint=str(new_ckpt)
                    )
                else:
                    scheduler.hot_swap(new_model, step=new_step, checkpoint=str(new_ckpt))
                state.model = new_model
                state.step, state.checkpoint = new_step, str(new_ckpt)
                if before is not None:
                    logger.info(
                        "reload: device memory %.3f GiB before, %.3f GiB after "
                        "(pinned requests keep the old weights resident)",
                        before, _device_memory_gib(device),
                    )
                return out

            state.reloader = _reload

        # Textfile snapshot of the /metrics text under --trace-dir (JAX's
        # node-exporter fallback): histograms ride along, exemplar trace ids
        # included. Rewritten every 5 s and once at exit.
        if args.trace_dir and cfg.telemetry.enabled and cfg.telemetry.prometheus_textfile:
            import threading

            from .telemetry.prometheus import render_prometheus, write_textfile

            prom_path = Path(args.trace_dir) / "metrics.prom"
            metrics_stop = threading.Event()

            def _snapshot_metrics() -> None:
                try:
                    write_textfile(prom_path, render_prometheus(
                        registry.latest(), registry.counters(), {"component": "serve"},
                        histograms=registry.histograms(),
                    ))
                except Exception:  # noqa: BLE001 — a snapshot must not kill serving
                    pass

            def _metrics_loop() -> None:
                while True:
                    _snapshot_metrics()
                    if metrics_stop.wait(5.0):
                        _snapshot_metrics()
                        return

            metrics_thread = threading.Thread(target=_metrics_loop, name="metrics-prom",
                                              daemon=True)
            metrics_thread.start()

        httpd = make_server(state, args.host, args.port)
        host, port = httpd.server_address[:2]
        # Machine-readable ready line: the bound port (--port 0) is read here.
        print(
            json.dumps(
                {
                    "serving": str(ckpt_path),
                    "host": host,
                    "port": port,
                    "mode": mode,
                    "policy": scheduler.policy if scheduler else None,
                    "router": len(scheduler.replicas) if use_router else None,
                    "device": str(device),
                }
            ),
            flush=True,
        )
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"serve failed: {exc}")
        return exit_code_for_exception(exc)
    finally:
        if metrics_stop is not None:
            metrics_stop.set()
        if metrics_thread is not None:
            metrics_thread.join(timeout=10.0)
        if scheduler is not None:
            scheduler.close()


def _device_memory_gib(device) -> float | None:
    """Memory the caching allocator holds on a CUDA ``device``, in GiB;
    None elsewhere."""
    if device.type != "cuda":
        return None
    import torch

    return torch.cuda.memory_allocated(device) / 2**30


def _serve_bench_arg_error(args: argparse.Namespace) -> str | None:
    """The first out-of-range serve-bench argument (JAX's checks)."""
    checks = (
        (args.requests < 1, "--requests must be >= 1"),
        (args.prompt_tokens_min < 1, "--prompt-tokens-min must be >= 1"),
        (args.max_new_tokens < 1, "--max-new-tokens must be >= 1"),
        (bool(args.long_fraction and not args.long_prompt_tokens),
         "--long-fraction needs --long-prompt-tokens"),
        (not 0.0 <= args.long_fraction <= 1.0, "--long-fraction must be in [0, 1]"),
        (args.shared_prefix_tokens < 0 or args.shared_prefix_count < 1,
         "--shared-prefix-tokens must be >= 0 and --shared-prefix-count >= 1"),
        (args.burst_factor <= 0, "--burst-factor must be > 0"),
        (args.deadline_ms is not None and args.deadline_ms <= 0, "--deadline-ms must be > 0"),
        (not 0.0 <= args.batch_fraction <= 1.0, "--batch-fraction must be in [0, 1]"),
        (args.max_rejected_frac is not None and not 0.0 <= args.max_rejected_frac <= 1.0,
         "--max-rejected-frac must be in [0, 1]"),
    )
    return next((msg for bad, msg in checks if bad), None)


def _bench_failures(block: dict, args: argparse.Namespace) -> list[str]:
    """serve-bench's gates (JAX ``_handle_serve_bench``): bucketed shapes,
    no failed or timed-out request, the per-token p99 and rejected bounds."""
    failures: list[str] = []
    compile_block = block.get("compile")  # none without an engine (batch-1 speculative)
    if compile_block is not None and not compile_block["within_budget"]:
        failures.append(
            f"decode-loop shape count exceeded the bucket budget: "
            f"{compile_block['prefill_programs']} prefill + "
            f"{compile_block['decode_programs']} decode > {compile_block['budget']}"
        )
    reqs = block["requests"]
    if reqs["failed"] or reqs["timed_out"]:
        failures.append(f"{reqs['failed']} failed / {reqs['timed_out']} timed-out requests")
    if args.max_per_token_p99_ms is not None:
        p99 = block["slo"]["per_token_ms"]["p99"]
        if p99 is None or p99 > args.max_per_token_p99_ms:
            failures.append(
                f"per-token p99 {p99} ms exceeds the --max-per-token-p99-ms bound "
                f"({args.max_per_token_p99_ms} ms)"
            )
    if args.max_rejected_frac is not None:
        frac = (reqs.get("rejected", 0) + reqs.get("shed", 0)) / max(1, reqs["submitted"])
        if frac > args.max_rejected_frac:
            failures.append(
                f"rejected+shed fraction {frac:.3f} exceeds the --max-rejected-frac "
                f"bound ({args.max_rejected_frac})"
            )
    return failures


def _verify_parity(model, requests: list, logger) -> dict:
    """The exactness contract of serve-bench --verify-parity: every
    completed request re-decoded alone through ``generate()`` with a
    generator seeded by its seed, as ``serve`` seeds a request; the served
    token ids must be the same."""
    import torch

    from .generation import generate

    device = next(model.parameters()).device
    mismatched = checked = 0
    for req in requests:
        if req.finish_reason not in ("eos", "length"):
            continue
        checked += 1
        generator = torch.Generator(device=device)
        generator.manual_seed(req.seed)
        out = generate(
            model,
            req.prompt_ids[None, :],
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            top_k=req.top_k,
            top_p=req.top_p,
            eos_token_id=req.eos_token_id,
            generator=generator,
        )
        ref = [int(t) for t in out[0, req.prompt_ids.shape[0]:]]
        if req.eos_token_id is not None and req.eos_token_id in ref:
            ref = ref[: ref.index(req.eos_token_id) + 1]
        if ref != req.tokens:
            mismatched += 1
            logger.warning(
                "parity mismatch on request %s: served %s != generate() %s",
                req.request_id, req.tokens, ref,
            )
    return {"checked": checked, "mismatched": mismatched,
            "bitwise_identical": mismatched == 0 and checked > 0}


def _handle_serve_bench(args: argparse.Namespace) -> int:
    """Seeded open-loop load run against the continuous-batching scheduler
    (JAX ``_handle_serve_bench``): the population arrives on an open-loop
    clock, the scheduler serves it, and the SLO block prints as JSON.
    Exit 1 when a gate fails: shapes outside the bucket budget, a failed
    or timed-out request, the per-token p99 or rejected-fraction bounds,
    and with ``--verify-parity`` any request whose tokens differ from
    ``generate()``'s. ``--router`` drives the replica router over in-process
    replicas instead of one scheduler. ``report.json``/``report.md`` (with the
    serving block) and the backend timeline's Perfetto ``trace.json`` land in
    ``--out``, each process's ``timeline.jsonl`` under ``--out/telemetry``."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_inference_flags(args, cfg)
    if unported is None:
        unported = _serve_bench_arg_error(args)
    if unported is not None:
        _emit_error(unported)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    scheduler = None
    try:
        from .distributed import resolve_device
        from .serving import build_requests, run_loadgen

        device = resolve_device(cfg.run.device)
        _, _, model = _build_decode_stack(cfg, device, logger)
        model, ckpt_path, _ = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger, quantize=args.quantize,
            ema=args.ema,
        )
        block_size = int(model.block_size)
        if args.max_new_tokens >= block_size:
            _emit_error(
                f"--max-new-tokens ({args.max_new_tokens}) must leave room "
                f"for a prompt within block_size ({block_size})"
            )
            return EXIT_CONFIG_ERROR
        pmax = args.prompt_tokens_max or min(32, block_size - args.max_new_tokens)
        pmax = min(pmax, block_size - args.max_new_tokens)
        pmin = min(args.prompt_tokens_min, pmax)
        # The mix knobs can push prompts past what a request may hold.
        worst_prompt = args.shared_prefix_tokens + max(
            pmax, args.long_prompt_tokens if args.long_fraction else 0
        )
        if worst_prompt + args.max_new_tokens > block_size:
            _emit_error(
                f"longest possible prompt ({worst_prompt} tokens incl. shared prefix) "
                f"+ --max-new-tokens ({args.max_new_tokens}) exceeds block_size ({block_size})"
            )
            return EXIT_CONFIG_ERROR
        # The out dir is resolved before the backend so each process's
        # timeline JSONL lands under {out_dir}/telemetry, which `trace
        # --run-dir {out_dir}` merges afterwards.
        out_dir = Path(args.out or (Path(cfg.output.root_dir) / "serve_bench"))
        bench_trace_dir = out_dir / "telemetry"
        try:
            if args.router:
                scheduler, registry = _build_router_backend(
                    cfg, model, logger, args, trace_dir=bench_trace_dir
                )
            else:
                scheduler, registry = _build_serving_backend(
                    cfg, model, logger, args, trace_dir=bench_trace_dir
                )
        except ConfigLoadError as exc:
            _emit_error(exc.message, details=exc.details, errors=exc.errors)
            return EXIT_CONFIG_ERROR
        except ValueError as exc:
            _emit_error(str(exc))
            return EXIT_CONFIG_ERROR

        requests = build_requests(
            num_requests=args.requests,
            seed=args.seed,
            vocab_size=int(model.vocab_size),
            prompt_tokens_min=pmin,
            prompt_tokens_max=pmax,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            shared_prefix_tokens=args.shared_prefix_tokens,
            shared_prefix_count=args.shared_prefix_count,
            long_fraction=args.long_fraction,
            long_prompt_tokens=args.long_prompt_tokens,
            deadline_ms=args.deadline_ms,
            batch_fraction=args.batch_fraction,
        )
        logger.info(
            "serve-bench: %d requests, prompts %d-%d tokens, %d new tokens, "
            "%.1f rps %s open-loop (seed %d, policy %s)",
            len(requests), pmin, pmax, args.max_new_tokens,
            args.rate_rps, args.arrival, args.seed, scheduler.policy,
        )
        scheduler.start()
        block = run_loadgen(
            scheduler,
            requests,
            rate_rps=args.rate_rps,
            seed=args.seed,
            timeout_sec=args.timeout_sec,
            arrival=args.arrival,
            burst_factor=args.burst_factor,
        )
        scheduler.close()
        block["checkpoint"] = str(ckpt_path)
        tracer = getattr(scheduler, "tracer", None)
        if tracer is not None:
            block["tracing"] = tracer.stats()
        failures = _bench_failures(block, args)
        if args.verify_parity:
            block["parity"] = _verify_parity(model, requests, logger)
            if block["parity"]["mismatched"]:
                failures.append(
                    f"{block['parity']['mismatched']}/{block['parity']['checked']} "
                    "requests diverged from sequential generate()"
                )
        # report.json / report.md with the serving block, and the backend
        # timeline (queue_wait → prefill → decode spans) as a Perfetto trace.
        from .telemetry.report import build_report, write_reports
        from .telemetry.timeline import EventTimeline

        timeline = getattr(scheduler, "timeline", None) or EventTimeline(None)
        report = build_report(
            run_id="serve-bench",
            run_name=cfg.run.name,
            registry=registry,
            timeline=timeline,
            memory=None,
            wall_time_sec=block["throughput"]["wall_sec"],
            serving=block,
        )
        json_path, md_path = write_reports(out_dir, report)
        trace_path = timeline.export_perfetto(out_dir / "trace.json")
        summary = {
            "serving": block,
            "report_json": str(json_path) if json_path else None,
            "report_md": str(md_path) if md_path else None,
            "trace_json": str(trace_path) if trace_path else None,
            "trace_dir": str(bench_trace_dir),
            "ok": not failures,
        }
        if failures:
            summary["failures"] = failures
        print(json.dumps(summary, indent=2), flush=True)
        if failures:
            _emit_error("; ".join(failures))
            return EXIT_FAILURE
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"serve-bench failed: {exc}")
        return exit_code_for_exception(exc)
    finally:
        if scheduler is not None:
            scheduler.close()


def _handle_trace(args: argparse.Namespace) -> int:
    """Fleet-wide request-trace reassembly (telemetry/trace_collect.py), a
    pure read of the timelines: scans every --run-dir for
    ``*timeline*.jsonl``, rebuilds cross-process span trees from the
    tail-sampled ``cat="trace"`` events (router root → traceparent-propagated
    replica children) and answers slowest/show/summary/merge. Reads JAX's
    run dirs as well as the port's."""
    from .telemetry.trace_collect import (
        collect_traces,
        critical_path,
        discover_sources,
        format_tree,
        merge_perfetto,
        slowest,
        summarize,
    )

    missing = [d for d in args.run_dirs if not Path(d).exists()]
    if missing:
        _emit_error(f"run dir(s) not found: {', '.join(missing)}")
        return EXIT_CONFIG_ERROR
    sources = discover_sources(args.run_dirs)
    if not sources:
        _emit_error(
            "no *timeline*.jsonl under the given --run-dir(s) — serve with "
            "--trace-dir (or point at a serve-bench out dir) so each process "
            "writes its timeline"
        )
        return EXIT_CONFIG_ERROR
    traces = collect_traces(sources)
    indent = None if args.json else 2

    if args.action == "merge":
        out = Path(args.out or (Path(args.run_dirs[0]) / "merged_trace.json"))
        merge_perfetto(sources, out, traces=traces)
        unaligned = [s.label for s in sources if s.start_unix_time is None]
        if unaligned and any(s.start_unix_time is not None for s in sources):
            print(
                "warning: timeline(s) with no segment header could not be "
                f"time-aligned with the fleet: {', '.join(unaligned)} — their "
                "events are rebased to the merge start, so cross-process "
                "ordering against them is not meaningful",
                file=sys.stderr,
            )
        print(json.dumps({
            "merged": str(out),
            "processes": [s.label for s in sources],
            "traces": len(traces),
            "unaligned": unaligned,
            "viewer": "https://ui.perfetto.dev",
        }, indent=indent))
        return EXIT_OK

    if not traces:
        _emit_error(
            "timelines found but no sampled request traces in them — only "
            "slow/errored/failed-over/forced requests keep full detail (tail "
            "sampling); force one with the `X-Trace: force` header or check "
            "telemetry.tracing.enabled"
        )
        return EXIT_FAILURE

    if args.action == "summary":
        print(json.dumps(summarize(traces), indent=indent))
        return EXIT_OK

    if args.action == "slowest":
        rows = []
        for tr in slowest(traces, k=args.k):
            root = tr.root
            rows.append({
                "trace_id": tr.trace_id,
                "total_ms": round(tr.duration_ms, 3),
                "root": root.name if root else None,
                "spans": len(tr.spans),
                "processes": tr.sources,
                "sampled": root.args.get("sampled") if root else None,
                "request_id": root.args.get("request_id") if root else None,
            })
        print(json.dumps(rows, indent=indent))
        return EXIT_OK

    if not args.trace_id:
        _emit_error(
            "`trace show` needs a trace id (or unique prefix) — list candidates "
            "with `trace slowest`"
        )
        return EXIT_CONFIG_ERROR
    matches = [t for t in traces.values() if t.trace_id.startswith(args.trace_id)]
    if not matches:
        _emit_error(f"no trace matching {args.trace_id!r} in the run dirs")
        return EXIT_FAILURE
    if len(matches) > 1:
        _emit_error(
            f"trace id prefix {args.trace_id!r} is ambiguous ({len(matches)} "
            "matches) — give more hex digits"
        )
        return EXIT_CONFIG_ERROR
    tr = matches[0]
    path = critical_path(tr)
    if args.json:
        print(json.dumps({"tree": format_tree(tr), "critical_path": path}))
    else:
        for line in format_tree(tr):
            print(line)
        print()
        print(json.dumps(path, indent=2))
    return EXIT_OK


def _handle_eval(args: argparse.Namespace) -> int:
    """Eval-only (JAX ``_handle_eval``): load a checkpoint's params and run
    the validation loop once; ``--quantize int8`` evaluates the quantized
    serving weights."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    level = "DEBUG" if args.verbose else cfg.logging.level
    configure_logging(level=level, json_output=cfg.logging.json_output)
    try:
        from .training.trainer import Trainer

        metrics = Trainer(cfg, None).evaluate(
            resume_from=args.from_spec,
            use_ema=args.ema,
            quantize=args.quantize if args.quantize != "none" else None,
        )
        if metrics is None:
            _emit_error("data module has no validation split to evaluate")
            return EXIT_FAILURE
        if args.json:
            print(json.dumps({"checkpoint": args.from_spec, "metrics": metrics}))
        else:
            print("  ".join(f"{k}={v:.6f}" for k, v in sorted(metrics.items())))
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        from .registry import RegistryError

        _emit_error(f"evaluation failed: {exc}")
        # A model or data module the port does not have is a config error,
        # as in `train`.
        return EXIT_CONFIG_ERROR if isinstance(exc, RegistryError) else exit_code_for_exception(exc)


def _handle_train_tokenizer(args: argparse.Namespace) -> int:
    """Train an offline BPE vocabulary (data/bpe.py) on local text (JAX
    ``_handle_train_tokenizer``): the same file walk, byte budget, training
    and stats; pairs with ``model.extra.tokenizer: "bpe:<output>"``."""
    import time

    from .data.bpe import train_bpe

    seen: set[Path] = set()
    files: list[Path] = []

    def _add(q: Path) -> None:
        r = q.resolve()
        if r not in seen:
            seen.add(r)
            files.append(q)

    for spec in args.input:
        p = Path(spec)
        if p.is_dir():
            for q in sorted(q for suf in ("*.txt", "*.md", "*.py") for q in p.rglob(suf)):
                _add(q)
        elif p.is_file():
            _add(p)
        else:
            _emit_error(f"input path not found: {spec}")
            return EXIT_CONFIG_ERROR
    if not files:
        _emit_error("no input files found (looked for *.txt, *.md, *.py in dirs)")
        return EXIT_CONFIG_ERROR

    budget = args.max_bytes  # enforced on UTF-8 bytes read, not characters
    pieces: list[str] = []
    for f in files:
        if budget <= 0:
            break
        with f.open("rb") as fh:
            raw = fh.read(budget)
        budget -= len(raw)
        pieces.append(raw.decode("utf-8", errors="ignore"))
    corpus = "\n\n".join(pieces)

    start = time.perf_counter()
    tok = train_bpe(corpus, args.vocab_size)
    elapsed = time.perf_counter() - start
    tok.save(args.output)

    n_tokens = len(tok.encode(corpus[:1_000_000]))
    n_bytes = len(corpus[:1_000_000].encode("utf-8"))
    stats = {
        "output": args.output,
        "vocab_size": tok.n_vocab,
        "corpus_bytes": len(corpus.encode("utf-8")),
        "files": len(files),
        "train_seconds": round(elapsed, 2),
        "bytes_per_token": round(n_bytes / max(n_tokens, 1), 3),
    }
    if args.json:
        print(json.dumps(stats))
    else:
        print(
            f"trained {stats['vocab_size']}-token BPE on {stats['corpus_bytes']} bytes "
            f"({stats['files']} files) in {stats['train_seconds']}s -> {args.output} "
            f"[{stats['bytes_per_token']} bytes/token]"
        )
    return EXIT_OK


# ------------------------------------------------------------ checkpoint tools
# export-checkpoint, import-checkpoint and average-checkpoints exit 1 on any
# failure, as JAX's do, except a refusal: a part not yet ported, or a model
# or data module the port does not have, is a config error (2).


def _tool_exit_code(exc: BaseException) -> int:
    from .registry import RegistryError

    refused = exit_code_for_exception(exc) == EXIT_CONFIG_ERROR or isinstance(exc, RegistryError)
    return EXIT_CONFIG_ERROR if refused else EXIT_FAILURE


def _tool_model(cfg):
    """The config's model on its device, freshly initialized (a LoRA
    config's LoraModel)."""
    from .distributed import resolve_device
    from .models.lora import build_adapter

    return build_adapter(cfg).build_model(cfg, resolve_device(cfg.run.device))


def _model_params(cfg, model):
    """A model's parameters as the JAX param tree (CPU tensors)."""
    from .interop import state_dict_to_flax_params

    return state_dict_to_flax_params(
        model.state_dict(), n_heads=cfg.model.n_heads,
        n_kv_heads=int(cfg.model.extra.get("n_kv_heads", 0)),
    )


def _load_checkpoint_params(cfg, model, from_spec: str, *, ema: bool = False):
    """The shared checkpoint load of export and average (JAX
    ``_load_checkpoint_params``): resolve the spec, load the params (with
    ``ema`` the EMA shadow) into ``model`` (strict, so the config's shapes
    are checked; a config mismatch warns), and return ``(ckpt_path,
    params, step)`` with the params as the JAX tree."""
    import yaml

    from .training.checkpoint import load_ema_params, load_inference_params, resolve_resume_path

    ckpt_path = resolve_resume_path(from_spec, cfg.output.root_dir)
    expected_yaml = yaml.safe_dump(cfg.model_dump(), sort_keys=False)
    load = load_ema_params if ema else load_inference_params
    step = load(ckpt_path, model, expected_config_yaml=expected_yaml)
    return ckpt_path, _model_params(cfg, model), step


def _save_fresh_checkpoint(cfg, model, params, out_dir: Path) -> Path:
    """``params`` (JAX tree) into ``model`` with a fresh optimizer state,
    committed as ``step_000000.ckpt`` in ``out_dir``: what ``train
    --resume`` takes (JAX ``create_train_state`` + ``save_host``)."""
    from .interop import flax_params_to_state_dict, is_lora_tree
    from .training.checkpoint import CheckpointManager
    from .training.checkpoint import opt_state_to_host
    from .training.optimizer import build_model_optimizer

    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    optimizer = build_model_optimizer(cfg, model)
    tree = _model_params(cfg, model)
    opt_state = opt_state_to_host(optimizer.state_dict(), n_heads=cfg.model.n_heads,
                                  n_kv_heads=int(cfg.model.extra.get("n_kv_heads", 0)),
                                  lora=is_lora_tree(tree))
    host = {"params": tree, "opt_state": opt_state}
    return CheckpointManager(out_dir).save_host(0, host, cfg.model_dump())


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _handle_average_checkpoints(args: argparse.Namespace) -> int:
    """Model soup (JAX ``_handle_average_checkpoints``): the uniform
    average of several checkpoints' params, float leaves accumulated in
    float64 and cast back, integer leaves kept from the first, written as
    a resumable ``step_000000.ckpt`` with a fresh optimizer state."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    try:
        import torch

        from .training.checkpoint import resolve_resume_path

        out_dir = Path(args.output)
        if out_dir.exists() and sorted(out_dir.glob("step_*.ckpt")):
            _emit_error(f"output dir {out_dir} already holds checkpoints; pass an empty directory")
            return EXIT_FAILURE
        specs = [s.strip() for s in args.inputs.split(",") if s.strip()]
        if args.last_k:
            if len(specs) != 1:
                _emit_error("--last-k needs --inputs to be ONE checkpoint dir")
                return EXIT_CONFIG_ERROR
            if args.last_k < 2:
                _emit_error("averaging needs at least 2 checkpoints")
                return EXIT_CONFIG_ERROR
            files = sorted(Path(specs[0]).glob("step_*.ckpt"))
            if len(files) < args.last_k:
                _emit_error(
                    f"{specs[0]} holds {len(files)} checkpoints, fewer than --last-k {args.last_k}"
                )
                return EXIT_CONFIG_ERROR
            paths = files[-args.last_k:]
        else:
            if len(specs) < 2:
                _emit_error("averaging needs at least 2 checkpoints")
                return EXIT_CONFIG_ERROR
            paths = [resolve_resume_path(s, cfg.output.root_dir) for s in specs]

        def as64(a):
            if a.is_floating_point():
                return a.double().numpy()
            return a.numpy()

        model = _tool_model(cfg)
        acc = params = None
        steps = []
        for p in paths:
            _, params, step = _load_checkpoint_params(cfg, model, str(p))
            steps.append(step)
            host = _tree_map(as64, params)
            acc = host if acc is None else _tree_map(
                lambda t, x: np.add(t, x) if np.issubdtype(t.dtype, np.floating) else t, acc, host
            )
        # Divide in float64, then cast back to the param dtype.
        avg = _tree_map(
            lambda s, like: torch.from_numpy(s / len(paths)).to(like.dtype)
            if like.is_floating_point() else torch.from_numpy(s),
            acc, params,
        )
        target = _save_fresh_checkpoint(cfg, model, avg, out_dir)
        stats = {"inputs": [str(p) for p in paths], "steps": steps, "checkpoint": str(target)}
        if args.json:
            print(json.dumps(stats))
        else:
            print(
                f"averaged {len(paths)} checkpoints (steps {steps}) -> {target}; "
                f"continue with: train --config {args.config} --resume {out_dir}"
            )
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"averaging failed: {exc}")
        return _tool_exit_code(exc)


def _handle_export_checkpoint(args: argparse.Namespace) -> int:
    """Export GPT weights as a reference torch GPT state dict (JAX
    ``_handle_export_checkpoint``; interop/torch_interop.py): the same
    keys, shapes and dtypes, ``causal_mask`` buffers and the tied
    ``lm_head.weight`` included."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    try:
        import torch

        from .interop import (
            is_llama_tree,
            is_pipeline_tree,
            llama_params_to_hf_state_dict,
            params_to_torch_state_dict,
            pipeline_params_to_gpt,
        )

        from .models.lora import to_inference_model

        model = _tool_model(cfg)
        ckpt_path, _, step = _load_checkpoint_params(cfg, model, args.from_spec, ema=args.ema)
        # A LoRA run exports its merged weights, the family's full-rank
        # state dict (JAX ``to_inference_params``).
        params = _model_params(cfg, to_inference_model(model))
        if is_pipeline_tree(params):
            # A pipeline run exports the per-layer gpt tree (same math).
            params = pipeline_params_to_gpt(params)
        # Each family exports in its ecosystem's layout: llama → HF
        # LlamaForCausalLM names, gpt → the reference torch GPT's.
        convert = (llama_params_to_hf_state_dict if is_llama_tree(params)
                   else params_to_torch_state_dict)
        sd = {k: torch.from_numpy(v) for k, v in convert(params).items()}
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        torch.save(sd, out)
        n_params = int(sum(v.numel() for v in sd.values()))
        stats = {
            "checkpoint": str(ckpt_path),
            "step": step,
            "output": str(out),
            "tensors": len(sd),
            "parameters": n_params,
        }
        if args.json:
            print(json.dumps(stats))
        else:
            print(f"exported step-{step} checkpoint -> {out} "
                  f"({len(sd)} tensors, {n_params:,} parameters)")
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"export failed: {exc}")
        return _tool_exit_code(exc)


def _handle_import_checkpoint(args: argparse.Namespace) -> int:
    """Reference torch GPT state dict → ``step_000000.ckpt`` with a fresh
    optimizer state (JAX ``_handle_import_checkpoint``); continue with
    ``train --resume <output dir>``."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    try:
        import torch

        from .interop import (
            gpt_params_to_pipeline,
            is_llama_tree,
            is_lora_tree,
            is_pipeline_tree,
            llama_params_from_hf_state_dict,
            params_from_torch_state_dict,
            pipeline_params_to_gpt,
        )

        out_dir = Path(args.output)
        existing = sorted(out_dir.glob("step_*.ckpt")) if out_dir.exists() else []
        if existing:
            # keep-last-k pruning would otherwise delete the imported step-0
            # file (or the user's own checkpoints).
            _emit_error(
                f"output dir {out_dir} already holds checkpoints "
                f"({existing[0].name}, ...); pass an empty directory"
            )
            return EXIT_FAILURE
        model = _tool_model(cfg)
        raw = torch.load(args.input, weights_only=True)
        template = _model_params(cfg, model)
        # Importing into a LoRA config fills the frozen base; the factors
        # keep their zero-delta init (JAX's fine-tuning entry point).
        lora = template["lora"] if is_lora_tree(template) else None
        template = template["base"] if lora is not None else template
        # A llama-family config reads an HF LlamaForCausalLM state dict.
        convert = (llama_params_from_hf_state_dict if is_llama_tree(template)
                   else params_from_torch_state_dict)
        if is_pipeline_tree(template):
            # A gpt_pipeline config: the torch per-layer weights through the
            # gpt-shaped template, then restacked.
            params = gpt_params_to_pipeline(
                params_from_torch_state_dict(dict(raw), pipeline_params_to_gpt(template)))
        else:
            params = convert(dict(raw), template)
        if lora is not None:
            params = {"base": params, "lora": lora}
        target = _save_fresh_checkpoint(cfg, model, params, out_dir)
        n_params = int(sum(p.numel() for p in model.parameters()))
        stats = {"input": args.input, "checkpoint": str(target), "parameters": n_params}
        if args.json:
            print(json.dumps(stats))
        else:
            print(
                f"imported {args.input} -> {target} ({n_params:,} parameters); "
                f"continue with: train --config {args.config} --resume {args.output}"
            )
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"import failed: {exc}")
        return _tool_exit_code(exc)


def _warn_unknown_extras(cfg) -> None:
    """Typos in the ``extra`` escape hatches are warnings, never errors
    (config/extras.py): the knobs are real but plugins may take keys the
    framework cannot know about. One line per section, JAX's words."""
    try:
        from .config.extras import unknown_extra_keys

        for section, keys in unknown_extra_keys(cfg).items():
            owner = {"model.extra": cfg.model.name,
                     "data.extra": cfg.data.name}.get(section, "trainer")
            print(
                f"warning: {section} keys not recognized by '{owner}': "
                f"{', '.join(keys)} (typo? they will be ignored)",
                file=sys.stderr,
            )
    except Exception:  # noqa: BLE001 — the check must never break a run
        pass


def _handle_validate(args: argparse.Namespace) -> int:
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora = _lora_spec_error(cfg)
    if lora is not None:
        _emit_error(lora)
        return EXIT_CONFIG_ERROR
    _warn_unknown_extras(cfg)
    if args.json:
        print(json.dumps({"valid": True, "config": args.config}))
    else:
        print("Config validation succeeded.")
    return EXIT_OK


def _handle_print_config(args: argparse.Namespace) -> int:
    try:
        _, _, resolved = load_and_validate_config(args.config)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return EXIT_CONFIG_ERROR
    if args.json:
        print(json.dumps(resolved, indent=2))
    else:
        import yaml

        print(yaml.safe_dump(resolved, sort_keys=False), end="")
    return EXIT_OK


def _handle_goodput(args: argparse.Namespace) -> int:
    """Post-hoc goodput ledger for any past run directory (JAX
    ``_handle_goodput``): a pure artifact read that works with every
    process of the run dead. Exit 0 with the ledger, 1 when the run dir has
    no segment-delimited timeline, 2 for a missing run dir."""
    from .telemetry.goodput import compute_goodput, render_goodput_md

    run_dir = Path(args.run_dir)
    if not run_dir.is_dir():
        _emit_error(f"run dir not found: {run_dir}")
        return EXIT_CONFIG_ERROR
    try:
        ledger = compute_goodput(run_dir)
    except NotImplementedError as exc:
        _emit_error(str(exc))
        return EXIT_CONFIG_ERROR
    if ledger is None:
        _emit_error(
            f"no goodput ledger for {run_dir}: telemetry/timeline.jsonl is "
            "missing or carries no segment headers (run predates the "
            "ledger, or telemetry.timeline was disabled)"
        )
        return EXIT_FAILURE
    if args.json:
        print(json.dumps(ledger))
    else:
        print(f"# Goodput — {run_dir}\n")
        print(render_goodput_md(ledger), end="")
    return EXIT_OK


def _handle_profile(args: argparse.Namespace) -> int:
    """N-step cost probe → ``profile_report.json`` (JAX ``_handle_profile``).

    Runs ``--steps`` real training steps on the config (run-dir-less, so no
    checkpoints or reports are written), then counts one train step on
    ``meta`` tensors (telemetry/profiling.py: the per-op table with every
    hand-written kernel, the roofline class). ``--serve`` adds the paged
    prefill/decode steps at their largest buckets, counted against a
    ``meta`` copy of the model (no checkpoint needed; nothing executes).
    Where JAX reports its compiled executable's compile time and memory
    analysis, the port has no counterpart and leaves the keys out."""
    import time

    from .registry import RegistryError, get_data_module, get_model_adapter, initialize_registries
    from .utils.logging import configure_logging, get_logger

    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    if args.steps < 1:
        _emit_error("--steps must be >= 1")
        return EXIT_CONFIG_ERROR
    configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    logger = get_logger()
    initialize_registries()
    try:
        get_model_adapter(cfg.model.name)
        get_data_module(cfg.data.name)
    except RegistryError as exc:
        _emit_error(str(exc))
        return EXIT_CONFIG_ERROR

    # Probe config: N steps, every boundary logged, no endpoint bind, no
    # report or attribution of its own (the profile builds its own).
    dump = cfg.model_dump()
    dump["trainer"]["max_steps"] = args.steps
    dump["trainer"]["log_every_steps"] = 1
    dump["telemetry"]["prometheus"] = False
    dump["telemetry"]["report"] = False
    dump["telemetry"]["perf_attribution"] = False
    try:
        probe_cfg = type(cfg).model_validate(dump)
    except ValueError as exc:  # e.g. warmup_steps past --steps (JAX raises here)
        _emit_error(f"the probe config of --steps {args.steps} does not validate: {exc}")
        return EXIT_CONFIG_ERROR

    from .telemetry import profiling
    from .training.trainer import Trainer

    try:
        trainer = Trainer(probe_cfg, None)
        t0 = time.perf_counter()
        result = trainer.fit()
        probe_wall = time.perf_counter() - t0
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        logger.exception("profile probe run failed: %s", exc)
        _emit_error(f"profile probe run failed: {exc}")
        return exit_code_for_exception(exc)

    peaks = profiling.resolve_peaks(trainer.device_kind(), cfg.telemetry.device_peaks)
    telemetry = trainer._telemetry
    latest = {k: v[0] for k, v in telemetry.metrics.latest().items()}
    step_time_sec = latest.get("train/step_time_sec") or 0.0

    executables: list[dict[str, Any]] = []
    train_prof = trainer.train_step_profile(peaks=peaks, full=True, top_k=args.top_k)
    if train_prof is not None:
        executables.append(train_prof)
    if args.serve:
        executables += _profile_serving_buckets(cfg, trainer.model, peaks=peaks,
                                                top_k=args.top_k, logger=logger)
    if not executables:
        _emit_error("no executable could be profiled (see logs)")
        return EXIT_FAILURE

    n_devices = trainer._world
    attribution = profiling.build_perf_attribution(
        executables=executables,
        peaks=peaks,
        n_chips=n_devices,
        step_time_ms=step_time_sec * 1e3 if step_time_sec > 0 else None,
        tokens_per_step=float(trainer._tokens_per_step) or None,
        palm_flops_per_token=trainer.palm_flops_per_token(),
        measured_mfu=latest.get("train/mfu"),
        span_totals=telemetry.timeline.span_totals(),
        steps=args.steps,
    )
    memory_block: dict[str, Any] = {}
    if telemetry.memory is not None:
        memory_block["monitor_peaks"] = dict(telemetry.memory.peaks())
        memory_block["monitor_source"] = telemetry.memory.source

    report = {
        "schema": "llmtrain-profile-report/1",
        "config": str(args.config),
        "run_name": cfg.run.name,
        "device_kind": peaks.get("device_kind", "unknown"),
        "n_devices": n_devices,
        "peaks": {k: peaks[k] for k in ("peak_flops", "hbm_bytes_per_sec", "ici_bytes_per_sec")},
        "probe": {
            "steps": args.steps,
            "wall_time_sec": round(probe_wall, 3),
            "step_time_ms": round(step_time_sec * 1e3, 3),
            "tokens_per_sec": latest.get("train/tokens_per_sec"),
            "mfu_measured": latest.get("train/mfu"),
            "final_loss": result.final_loss,
        },
        "executables": executables,
        "perf_attribution": attribution,
        "memory": memory_block,
    }
    if args.output is not None:
        out_path = Path(args.output)
    else:
        out_path = Path(cfg.output.root_dir) / f"profile_{cfg.run.name}" / "profile_report.json"
    try:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(report, indent=2, sort_keys=False), encoding="utf-8")
    except (OSError, TypeError, ValueError) as exc:
        _emit_error(f"writing {out_path} failed: {exc}")
        return EXIT_FAILURE

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        lines = [f"profile report: {out_path}"]
        for exe in executables:
            roof = exe.get("roofline") or {}
            lines.append(
                f"  {exe['name']}: {exe.get('flops', 0.0):.3g} flops, "
                f"{exe.get('bytes_accessed', 0.0):.3g} bytes, "
                f"compile {exe.get('compile_time_s', 0.0):.2f}s → "
                f"{roof.get('class', '?')}-bound"
            )
            for row in profiling.render_top_ops_markdown(exe.get("top_ops") or []):
                lines.append("    " + row)
        mfu_block = attribution.get("mfu") or {}
        if mfu_block:
            lines.append(
                f"  MFU analytical {mfu_block.get('analytical')} vs measured "
                f"{mfu_block.get('measured')} (ratio "
                f"{mfu_block.get('ratio_analytical_over_measured')}, "
                f"reconciled: {mfu_block.get('reconciled')})"
            )
        print("\n".join(lines))
    return EXIT_OK


def _profile_serving_buckets(cfg, model, *, peaks: dict[str, float], top_k: int,
                             logger) -> list[dict[str, Any]]:
    """Counts of the paged prefill/decode steps, checkpoint-free: the engine
    is built over a ``meta`` copy of ``model`` (the probe's), so neither its
    weights nor its pool take memory, and nothing executes. Failures
    degrade to an empty list (the train-step profile stands on its own)."""
    try:
        from .serving import PagedDecodeEngine
        from .telemetry import profiling

        if not hasattr(model, "for_paged_decoding"):
            logger.warning(
                "model %s has no paged-decoding support; skipping serve profiles",
                cfg.model.name,
            )
            return []
        scfg = cfg.serving
        engine = PagedDecodeEngine(
            profiling.meta_module(model),
            block_tokens=scfg.block_tokens,
            num_blocks=scfg.num_blocks or None,
            max_batch_slots=scfg.max_batch_slots,
            prompt_buckets=scfg.prompt_buckets or None,
            batch_buckets=scfg.batch_buckets or None,
        )
        return engine.cost_profile(peaks=peaks, top_k=top_k)
    except Exception as exc:  # noqa: BLE001 — serve profiles are additive
        logger.warning("serving bucket profile failed: %s", exc)
        return []


def _handle_chaos(args: argparse.Namespace) -> int:
    """Seeded kill/resume drill over real ``train`` subprocesses (JAX's
    ``_handle_chaos``). Exit 0 only when every cycle's invariants held AND
    the final trajectory is bitwise-identical to the uninterrupted
    reference; 1 when the crash-consistency contract broke; 2 for config
    problems."""
    from .utils.logging import configure_logging, get_logger

    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    if args.cycles < 1:
        _emit_error("--cycles must be >= 1")
        return EXIT_CONFIG_ERROR
    configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    logger = get_logger()
    from .resilience.chaos import ChaosInvariantError, run_chaos

    try:
        result = run_chaos(
            args.config,
            cycles=args.cycles,
            seed=args.seed,
            max_steps=args.max_steps,
            save_every=args.save_every,
            work_dir=args.work_dir,
            timeout_sec=args.timeout_sec,
        )
    except ChaosInvariantError as exc:
        logger.error("chaos drill FAILED: %s", exc)
        _emit_error(f"chaos invariant violated: {exc}")
        return EXIT_FAILURE
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        logger.exception("chaos drill errored: %s", exc)
        _emit_error(f"chaos drill errored: {exc}")
        return exit_code_for_exception(exc)
    if args.json:
        print(json.dumps(result))
    else:
        print(
            f"chaos drill passed: {result['kills_delivered']} kill(s) "
            f"(incl. {result['kill_during_checkpoint_cycles']} inside a "
            f"checkpoint write) over {result['max_steps']} steps; "
            f"{result['trajectory_points_compared']} trajectory point(s) and "
            f"the final checkpoint are bitwise-identical to the "
            f"uninterrupted reference (final_loss="
            f"{result['final_loss']}); artifacts in {result['work_dir']}"
        )
        if result.get("goodput"):
            gp = result["goodput"]
            print(
                f"goodput: {gp['goodput_frac']:.4f} of {gp['wall_clock_sec']}s "
                f"wall-clock across {gp['num_segments']} segment(s) "
                f"(recomputed {gp['categories']['recomputed']}s, "
                f"restart_overhead {gp['categories']['restart_overhead']}s) — "
                "full ledger via `llmtrain goodput --run-dir "
                f"{result['work_dir']}/runs/chaos`"
            )
    return EXIT_OK


def _handle_plan(args: argparse.Namespace) -> int:
    """The analytic half of the tuner (JAX ``_handle_plan``): resolve,
    predict, print; nothing runs, no parameters materialize. Exit 2 for an
    infeasible plan or a prediction over the device's memory."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code

    from .autotune.plan import (
        MeshPlanError,
        config_loss_impl,
        plan_from_config,
        predict_hbm_bytes,
    )
    from .autotune.search import analytic_candidate_cost, resolve_hbm_limit
    from .autotune.tune import local_device_count
    from .registry import RegistryError, get_model_adapter, initialize_registries
    from .telemetry.profiling import classify_roofline, resolve_peaks

    initialize_registries()
    try:
        adapter = get_model_adapter(cfg.model.name)
    except RegistryError as exc:
        _emit_error(str(exc))
        return EXIT_CONFIG_ERROR
    device_count = args.devices if args.devices is not None else local_device_count(cfg)
    try:
        mesh_plan = plan_from_config(cfg, device_count, adapter=adapter)
    except MeshPlanError as exc:
        _emit_error(f"infeasible plan: {exc}")
        return EXIT_CONFIG_ERROR

    peaks = resolve_peaks(None, cfg.telemetry.device_peaks)
    cost = analytic_candidate_cost(mesh_plan, cfg)
    roofline = classify_roofline(
        flops=cost["flops"],
        bytes_accessed=cost["bytes_accessed"],
        collective_bytes=cost["collective_bytes"],
        peaks=peaks,
    )
    # The loss the run would build decides the logits buffer charged.
    loss_impl, ce_chunk = config_loss_impl(cfg)
    hbm = predict_hbm_bytes(
        mesh_plan,
        n_params=int(cost["n_params"]),
        d_model=cfg.model.d_model,
        n_layers=cfg.model.n_layers,
        vocab_size=int(cfg.model.vocab_size or 50257),
        block_size=cfg.model.block_size,
        dtype_bytes=2 if cfg.model.dtype == "bfloat16" else 4,
        param_dtype_bytes=2 if cfg.model.param_dtype == "bfloat16" else 4,
        loss_impl=loss_impl,
        ce_chunk=ce_chunk,
    )
    hbm_limit = resolve_hbm_limit(str(peaks.get("device_kind", "cpu")),
                                  cfg.tune.hbm_limit_bytes)
    feasible = hbm["total_bytes"] <= hbm_limit
    payload = {
        "plan": {
            "key": mesh_plan.key(),
            "mesh": mesh_plan.axes,
            "device_count": device_count,
            "data_parallel": mesh_plan.data_parallel,
            "global_micro_batch": mesh_plan.global_micro_batch,
            "micro_batch_size": mesh_plan.micro_batch_size,
            "grad_accum_steps": mesh_plan.grad_accum_steps,
            "remat": mesh_plan.remat,
            "zero_stage": mesh_plan.zero_stage,
            "activation_tiers": mesh_plan.activation_tiers,
            "loss_impl": loss_impl,
            "topology": mesh_plan.describe_topology(),
        },
        "roofline": roofline,
        "predicted_hbm": hbm,
        "hbm_limit_bytes": hbm_limit,
        "device_kind": peaks.get("device_kind", "unknown"),
        "feasible": feasible,
    }
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        print(f"plan      {mesh_plan.key()}")
        print(f"mesh      {mesh_plan.axes}")
        print(f"batch     micro={mesh_plan.micro_batch_size} "
              f"global_micro={mesh_plan.global_micro_batch} "
              f"accum={mesh_plan.grad_accum_steps}")
        print(f"roofline  {roofline['class']} (analytical ms: {roofline['analytical_ms']})")
        print(f"hbm       {hbm['total_bytes'] / 2**30:.3f} GiB predicted vs "
              f"{hbm_limit / 2**30:.1f} GiB limit [{payload['device_kind']}]")
        print(f"loss      {loss_impl} (logits buffer {hbm['logits_bytes'] / 2**20:.1f} MiB)")
        by_tier = hbm.get("activation_bytes_by_tier", {})
        if by_tier:
            breakdown = " ".join(f"{tier}={v / 2**30:.3f}GiB"
                                 for tier, v in sorted(by_tier.items()))
            line = f"acts      {breakdown}"
            if hbm.get("activation_host_bytes", 0):
                line += f" host_offload={hbm['activation_host_bytes'] / 2**30:.3f}GiB"
            print(line)
    if not feasible:
        _emit_error(
            "infeasible plan: predicted per-device HBM "
            f"{hbm['total_bytes'] / 2**30:.3f} GiB exceeds the "
            f"{hbm_limit / 2**30:.1f} GiB limit for "
            f"{payload['device_kind']} (override with tune.hbm_limit_bytes)"
        )
        return EXIT_CONFIG_ERROR
    return EXIT_OK


def _handle_tune(args: argparse.Namespace) -> int:
    """JAX ``_handle_tune``: enumerate, prune, probe, emit the winner."""
    try:
        cfg, _, resolved = load_and_validate_config(args.config)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return EXIT_CONFIG_ERROR

    from .autotune.plan import MeshPlanError
    from .autotune.tune import run_tune

    workdir = Path(args.workdir or Path(cfg.output.root_dir) / f"tune_{cfg.run.name}")
    output_path = Path(args.output or workdir / "tuned.yaml")
    try:
        report = run_tune(cfg, resolved, workdir=workdir, output_path=output_path)
    except MeshPlanError as exc:
        _emit_error(f"infeasible plan: {exc}")
        return EXIT_CONFIG_ERROR
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"tune      {report['enumerated']} candidates enumerated, "
              f"{len(report['pruned'])} pruned analytically, "
              f"{len(report['measured'])} probed "
              f"({report['elapsed_sec']:.1f}s of {report['budget_sec']:.0f}s budget)")
        for record in report["measured"]:
            status = record.get("status")
            if status == "ok":
                marker = "*" if record["key"] == report["winner"]["key"] else " "
                print(f"  {marker} {record['key']}: mfu={record['mfu']:.4f} "
                      f"step={record.get('step_time_sec') or 0:.4f}s"
                      + (" (baseline)" if record.get("baseline") else ""))
            else:
                print(f"    {record['key']}: {status} ({record.get('reason', '')})")
        print(f"winner    {report['winner']['key']}")
        print(f"emitted   {report['output_config']}")
        print(f"report    {workdir / 'tune_report.json'}")
    return EXIT_OK


def _resolve_watch_dirs(watch: str) -> tuple[Path, Path]:
    """``--watch`` path → (run_dir, ckpt_dir). Accepts the run dir (the
    conventional layout puts checkpoints in ``{run_dir}/checkpoints``)
    or the checkpoints dir itself."""
    path = Path(watch)
    if path.name == "checkpoints":
        return path.parent, path
    if (path / "checkpoints").is_dir() or not any(
        p.name.startswith("step_") for p in (path.glob("step_*") if path.is_dir() else [])
    ):
        return path, path / "checkpoints"
    # A dir holding step_* files directly IS the checkpoint dir.
    return path.parent, path


def _handle_promote(args: argparse.Namespace) -> int:
    """Continuous train→canary→promote lifecycle (lifecycle/controller.py;
    JAX ``_handle_promote``).

    Watches the training run's manifest stream (durable artifacts only),
    serves an in-process replica fleet from the promoted baseline,
    canaries each new commit on one replica, scores it over a soak window
    (held-out eval loss + TTFT/per-token percentiles, optional A/B traffic
    split), then promotes fleet-wide via rolling reload or rolls the
    canary back. Every decision is a durable ``promotions.jsonl`` entry
    the goodput ledger attributes.

    Every candidate loads into a FRESH decode module: the replicas' hot
    swap keeps in-flight requests on the module they were admitted under,
    so a module an older epoch still reads is never written; a rollback
    hands the replica back the baseline's own module.

    Exit taxonomy: training finished (report.json) or the promotion budget
    spent → 0; the training run dying mid-stream (stale heartbeat, no
    report) → 1 (EXIT_TRAIN_FAILURE).
    """
    import time

    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    lora_err = _lora_spec_error(cfg)
    if lora_err is not None:
        _emit_error(lora_err)
        return EXIT_CONFIG_ERROR
    pcfg = cfg.promote
    overrides: dict[str, Any] = {}
    if args.max_promotions is not None:
        overrides["max_promotions"] = args.max_promotions
    if args.idle_timeout_sec is not None:
        overrides["idle_timeout_sec"] = args.idle_timeout_sec
    if overrides:
        pcfg = pcfg.model_copy(update=overrides)

    run_dir, ckpt_dir = _resolve_watch_dirs(args.watch)
    if not run_dir.is_dir():
        _emit_error(f"--watch run dir not found: {run_dir}")
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    router = None
    timeline = None
    try:
        from .distributed import resolve_device
        from .lifecycle import (
            CheckpointWatcher,
            PromotionController,
            PromotionLedger,
            RouterFleet,
        )

        ledger = PromotionLedger(run_dir / "promotions.jsonl")
        watcher = CheckpointWatcher(ckpt_dir, run_dir=run_dir)

        # Baseline: the last promoted checkpoint (ledger replay — a
        # SIGKILLed promote resumes where it decided, never re-promotes),
        # else --from, else the stream's first commit (waited for).
        spec = None
        promoted = ledger.last_promoted()
        if promoted and promoted.get("checkpoint") and Path(promoted["checkpoint"]).exists():
            spec = promoted["checkpoint"]
            logger.info(
                "promote: resuming from ledger — step %d is the baseline", promoted["step"]
            )
        elif args.from_spec:
            spec = args.from_spec
        else:
            deadline = time.monotonic() + pcfg.idle_timeout_sec
            while spec is None:
                polled = watcher.poll(after_step=-1)
                if polled is not None:
                    spec = str(polled[0])
                    break
                if time.monotonic() > deadline:
                    _emit_error(
                        f"promote: no committed checkpoint appeared in "
                        f"{ckpt_dir} within {pcfg.idle_timeout_sec:.0f}s"
                    )
                    return EXIT_FAILURE
                time.sleep(pcfg.poll_sec)

        device = resolve_device(cfg.run.device)

        def load_module(ckpt: str, label: str):
            _, _, fresh = _build_decode_stack(cfg, device, logger)
            return _load_decode_params(
                cfg, fresh, ckpt, args.decode_param_dtype, logger, quantize=args.quantize,
                ema=args.ema, label=label,
            )

        model, ckpt_path, step = load_module(str(spec), "promote ")
        router, registry = _build_router_backend(cfg, model, logger, args)
        if len(router.replicas) < 2:
            logger.warning(
                "promote: a 1-replica fleet has no reference replica — the SLO "
                "A/B gate is skipped (only failures and eval loss gate promotion)"
            )

        def load_params(ckpt: Path):
            return load_module(str(ckpt), "candidate ")[0]

        evaluator = None
        if not args.no_eval:
            from .training.trainer import Trainer

            eval_trainer = Trainer(cfg, None)

            def evaluator(ckpt: Path) -> float | None:
                metrics = eval_trainer.evaluate(resume_from=str(ckpt))
                if metrics is None:
                    return None
                return float(metrics["val/loss"])

        if cfg.telemetry.enabled and cfg.telemetry.timeline:
            from .telemetry.timeline import EventTimeline

            tdir = run_dir / "telemetry"
            tdir.mkdir(parents=True, exist_ok=True)
            # Separate file: appending promote segments into the trainer's
            # timeline.jsonl would corrupt the goodput ledger's segment
            # accounting.
            timeline = EventTimeline(
                tdir / "promote_timeline.jsonl",
                max_events=cfg.telemetry.max_events,
                xprof_annotations=False,
            )

        fleet = RouterFleet(
            router,
            vocab_size=model.vocab_size,
            max_new_tokens=min(8, cfg.serving.max_new_tokens_cap),
        )
        try:
            controller = PromotionController(
                cfg=pcfg,
                watcher=watcher,
                fleet=fleet,
                ledger=ledger,
                baseline_params=model,
                baseline_step=step,
                baseline_checkpoint=str(ckpt_path),
                load_params=load_params,
                evaluator=evaluator,
                registry=registry,
                timeline=timeline,
            )
        except ValueError as exc:
            _emit_error(str(exc))
            return EXIT_CONFIG_ERROR
        result = controller.run()

        payload = {
            "status": result.status,
            "promotions": result.promotions,
            "rollbacks": result.rollbacks,
            "aborts": result.aborts,
            "last_promoted_step": result.last_promoted_step,
            "ledger": str(ledger.path),
        }
        if args.json:
            print(json.dumps(payload))
        else:
            print(
                f"promote: {result.status} — {result.promotions} promoted, "
                f"{result.rollbacks} rolled back, {result.aborts} aborted "
                f"(serving step {result.last_promoted_step}); ledger {ledger.path}"
            )
        if result.status == "training_dead":
            # The watched run died mid-stream: surface it on the exit
            # taxonomy so a supervisor treats promote like the trainer.
            return EXIT_TRAIN_FAILURE
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        _emit_error(f"promote failed: {exc}")
        return exit_code_for_exception(exc)
    finally:
        if timeline is not None:
            try:
                timeline.flush()
            except Exception:  # noqa: BLE001 — best-effort telemetry
                pass
        if router is not None:
            try:
                from .telemetry.prometheus import render_prometheus

                tdir = run_dir / "telemetry"
                tdir.mkdir(parents=True, exist_ok=True)
                (tdir / "promote_metrics.prom").write_text(
                    render_prometheus(
                        dict(router.registry.latest()),
                        router.registry.counters(),
                        {"component": "promote"},
                    ),
                    encoding="utf-8",
                )
            except Exception:  # noqa: BLE001 — best-effort telemetry
                pass
            router.close()


def _handle_fleet(args: argparse.Namespace) -> int:
    """Multi-tenant fleet supervisor / preemption-storm drill (JAX
    ``_handle_fleet``): tenants are groups of ranks on the CPU
    (``run.device: cpu``) or on the card.

    Exit 0 when every tenant completed (and, under --storm, every parity
    and scheduling invariant held); exit 1 when a tenant failed or an
    invariant broke; exit 2 for config problems."""
    try:
        cfg, _, resolved = load_and_validate_config(args.config)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return EXIT_CONFIG_ERROR
    from .resilience.harness import DrillInvariantError
    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)

    try:
        if args.storm:
            from .fleet.chaos import run_fleet_storm

            result = run_fleet_storm(
                args.config,
                seed=args.seed,
                max_steps=args.max_steps,
                save_every=args.save_every,
                work_dir=args.work_dir,
                timeout_sec=args.timeout_sec,
                step_delay_sec=args.step_delay_sec,
            )
            if args.json:
                print(json.dumps(result))
            else:
                parities = {
                    n: r["parity"] for n, r in result["tenants"].items()
                }
                print(
                    f"fleet storm passed: {result['total_evictions']} "
                    f"eviction(s) (mid-checkpoint kill on "
                    f"{result['mid_checkpoint_kill_tenant']}), "
                    f"{result['total_respawns']} respawn(s), "
                    f"{result['capacity_changes']} capacity change(s) across "
                    f"{len(result['tenants'])} tenant(s); per-tenant parity "
                    f"{parities}; artifacts in {result['work_dir']}"
                )
            return EXIT_OK

        from .fleet.supervisor import FleetSupervisor

        work_dir = args.work_dir or str(
            Path(cfg.output.root_dir) / f"fleet_{cfg.run.name}"
        )
        try:
            sup = FleetSupervisor(
                cfg,
                resolved,
                work_dir=work_dir,
                seed=args.seed,
                max_steps=args.max_steps,
                save_every=args.save_every,
                fresh=args.fresh,
            )
        except ValueError as exc:
            # Constructor-time validation only (no tenants, wrong device,
            # infeasible world sizes): deterministic config problems. A
            # ValueError INSIDE the run is a runtime failure and takes the
            # taxonomy path below.
            _emit_error(str(exc))
            return EXIT_CONFIG_ERROR
        try:
            report = sup.run(timeout_sec=args.timeout_sec)
        except DrillInvariantError:
            raise  # the outer handler maps it to EXIT_FAILURE
        except Exception as exc:  # noqa: BLE001 — run-time, NOT config
            # Includes ValueError: past construction, nothing about the
            # config is in question — route through the taxonomy instead
            # of the outer config-error mapping.
            logger.exception("fleet run errored: %s", exc)
            _emit_error(f"fleet run errored: {exc}")
            return exit_code_for_exception(exc)
        if args.json:
            print(json.dumps(report))
        else:
            print(
                f"fleet run finished: {report['totals']['completed']}/"
                f"{len(report['tenants'])} tenant(s) completed, "
                f"{report['totals']['evictions']} eviction(s), "
                f"{report['totals']['respawns']} respawn(s); report in "
                f"{sup.work_dir / 'fleet_report.json'}"
            )
        return EXIT_OK if report["totals"]["failed"] == 0 else EXIT_FAILURE
    except DrillInvariantError as exc:
        logger.error("fleet invariant violated: %s", exc)
        _emit_error(f"fleet invariant violated: {exc}")
        return EXIT_FAILURE
    except ValueError as exc:
        # Storm pre-run validation (tenant count, infeasible fault
        # windows, supervisor construction) raises ValueError before any
        # subprocess launches — deterministic config problems.
        _emit_error(str(exc))
        return EXIT_CONFIG_ERROR
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        logger.exception("fleet run errored: %s", exc)
        _emit_error(f"fleet run errored: {exc}")
        return exit_code_for_exception(exc)


_HANDLERS = {
    "promote": _handle_promote,
    "fleet": _handle_fleet,
    "plan": _handle_plan,
    "tune": _handle_tune,
    "train": _handle_train,
    "chaos": _handle_chaos,
    "generate": _handle_generate,
    "serve": _handle_serve,
    "serve-bench": _handle_serve_bench,
    "trace": _handle_trace,
    "profile": _handle_profile,
    "goodput": _handle_goodput,
    "eval": _handle_eval,
    "train-tokenizer": _handle_train_tokenizer,
    "export-checkpoint": _handle_export_checkpoint,
    "import-checkpoint": _handle_import_checkpoint,
    "average-checkpoints": _handle_average_checkpoints,
    "validate": _handle_validate,
    "print-config": _handle_print_config,
}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return _HANDLERS[args.command](args)


__all__ = ["build_parser", "main", "prepare_decode_model"]
