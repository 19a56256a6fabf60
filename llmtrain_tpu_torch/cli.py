"""Command-line interface of the port: ``python -m llmtrain_tpu_torch``.

Same subcommands, flags, JSON shapes and exit codes as the JAX CLI
(``llmtrain_tpu/cli.py``) for the surface this slice ports:

* ``train`` — config → run directory (``config.yaml``, ``meta.json``,
  ``logs/``, ``checkpoints/``) → the trainer (training/trainer.py), with
  ``--run-id``, ``--dry-run``, ``--json``, ``-v``, ``--resume`` and
  ``--auto-resume``; the run summary on stdout;
* ``generate`` — checkpoint → ``generate()`` (KV-cache or re-forward branch);
* ``serve`` — checkpoint → HTTP server (serving/http.py): simple mode, or
  ``--mode continuous`` / ``serving.mode: continuous``, the paged-KV
  continuous-batching scheduler with overload control and ``POST /reload``;
* ``serve-bench`` — checkpoint → a seeded open-loop load against the
  continuous-batching scheduler, its SLO block as JSON, the bounded-shape,
  failure and latency gates, and ``--verify-parity`` against ``generate()``;
* ``validate`` / ``print-config`` — the config loader.

Exit codes: 0 ok, 1 failure, 2 config error (a feature that is not yet
ported counts as a config error). Flags whose feature is not yet ported
(``--ema``, ``--draft-*`` and the speculative policy, ``--quantize int8``,
the router, ``--trace-dir``) and LoRA or pipeline checkpoints exit 2 with a
message naming the ROADMAP.md item. ``run.device`` (default ``cuda``) picks
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

EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_CONFIG_ERROR = 2

_NOT_PORTED = "is not yet ported to llmtrain_tpu_torch"


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
    gen.add_argument("--draft-config", default=None, help="speculative decoding (not yet ported)")
    gen.add_argument("--draft-from", default=None, help="speculative decoding (not yet ported)")
    gen.add_argument("--gamma", type=int, default=4, help="speculative lookahead (not yet ported)")
    gen.add_argument(
        "--logprobs", action="store_true",
        help="include the model's log-probability of every emitted token in the JSON output",
    )
    gen.add_argument("--ema", action="store_true", help="EMA shadow weights (not yet ported)")
    gen.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="weight-only quantization (int8 not yet ported)",
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
    serve.add_argument("--draft-config", default=None, help="speculative serving (not yet ported)")
    serve.add_argument("--draft-from", default=None, help="speculative serving (not yet ported)")
    serve.add_argument("--gamma", type=int, default=None, help="speculative lookahead (not yet ported)")
    serve.add_argument(
        "--decode-param-dtype", choices=("compute", "param"), default="compute",
        help="as in generate",
    )
    serve.add_argument("--ema", action="store_true", help="EMA shadow weights (not yet ported)")
    serve.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="weight-only quantization (int8 not yet ported)",
    )
    serve.add_argument(
        "--eos-token-id", type=int, default=None,
        help="default stop token (requests may override; default: the tokenizer's EOS, if any)",
    )
    serve.add_argument("--router", action="store_true", help="replica router (not yet ported)")
    serve.add_argument("--replicas", type=int, default=None, help="router replicas (not yet ported)")
    serve.add_argument("--backends", default=None, help="router backends (not yet ported)")
    serve.add_argument("--discover", default=None, help="router discovery (not yet ported)")
    serve.add_argument("--trace-dir", default=None, help="request traces (not yet ported)")

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
        help="report directory (report.json/report.md are not yet ported)",
    )
    bench.add_argument(
        "--decode-param-dtype", choices=("compute", "param"), default="compute",
        help="as in generate/serve",
    )
    bench.add_argument("--ema", action="store_true", help="EMA shadow weights (not yet ported)")
    bench.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="weight-only quantization (int8 not yet ported)",
    )
    bench.add_argument("--draft-config", default=None, help="speculative policy (not yet ported)")
    bench.add_argument("--draft-from", default=None, help="speculative policy (not yet ported)")
    bench.add_argument("--gamma", type=int, default=None, help="speculative lookahead (not yet ported)")
    bench.add_argument("--router", action="store_true", help="replica router (not yet ported)")
    bench.add_argument("--replicas", type=int, default=None, help="router replicas (not yet ported)")
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


def _unported_inference_flags(args: argparse.Namespace, cfg) -> str | None:
    """Message for the first requested feature this slice does not run."""
    if args.ema:
        return f"--ema (EMA shadow weights) {_NOT_PORTED} (ROADMAP.md queue A: slice 2 deferrals)"
    if args.draft_config is not None or args.draft_from is not None:
        return (
            f"--draft-config/--draft-from (speculative decoding) {_NOT_PORTED} "
            "(ROADMAP.md queue A: speculative decoding)"
        )
    if args.quantize != "none":
        return (
            f"--quantize {args.quantize} {_NOT_PORTED} "
            "(ROADMAP.md queue A: int8 quantization)"
        )
    if cfg.model.extra.get("lora") is not None:
        return f"LoRA models (model.extra.lora) {_NOT_PORTED} (ROADMAP.md queue A: model zoo)"
    return None


def _exit_code(exc: BaseException) -> int:
    from .training.trainer import TopologyMismatchError

    config_errors = (NotImplementedError, TopologyMismatchError)
    return EXIT_CONFIG_ERROR if isinstance(exc, config_errors) else EXIT_FAILURE


def _handle_train(args: argparse.Namespace) -> int:
    """The JAX ``_handle_train`` on one process: run dir, config copy,
    meta.json, logging, then the trainer or the dry run, then the summary."""
    from .registry import RegistryError, get_data_module, get_model_adapter, initialize_registries
    from .utils.logging import configure_logging, get_logger
    from .utils.metadata import generate_meta, write_meta_json
    from .utils.run_dir import create_run_directory, write_resolved_config
    from .utils.run_id import generate_run_id
    from .utils.summary import format_run_summary

    try:
        cfg, _, resolved = load_and_validate_config(args.config)
    except ConfigLoadError as exc:
        _emit_error(exc.message, details=exc.details, errors=exc.errors)
        return EXIT_CONFIG_ERROR
    logger = get_logger()
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
        resume_spec = args.resume
        try:
            run_dir = create_run_directory(cfg.output.root_dir, run_id)
        except FileExistsError:
            if not args.auto_resume:
                _emit_error(
                    f"run directory already exists for run id {run_id!r}",
                    details="pass a fresh --run-id or let the run id be generated",
                )
                return EXIT_FAILURE
            from .training.checkpoint import CheckpointManager

            run_dir = Path(cfg.output.root_dir) / run_id
            (run_dir / "logs").mkdir(parents=True, exist_ok=True)
            if CheckpointManager(run_dir / "checkpoints").latest_checkpoint() is not None:
                resume_spec = str(run_dir / "checkpoints")

        log_file = None
        if cfg.logging.log_to_file:
            log_file = run_dir / "logs" / cfg.logging.file_name
        level = "DEBUG" if args.verbose else cfg.logging.level
        configure_logging(level=level, json_output=cfg.logging.json_output, log_file=log_file)
        if cfg.output.save_config_copy:
            write_resolved_config(run_dir, resolved)
        if cfg.output.save_meta_json:
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

        if args.dry_run:
            from .training.dry_run import run_dry_run

            summary = format_run_summary(
                cfg, run_id=run_id, run_dir=str(run_dir), dry_run=True,
                dry_run_result=run_dry_run(cfg), as_json=args.json,
            )
        else:
            from .training.trainer import Trainer

            result = Trainer(cfg, run_dir).fit(resume_from=resume_spec)
            summary = format_run_summary(
                cfg, run_id=run_id, run_dir=str(run_dir), dry_run=False,
                train_result=result, as_json=args.json,
            )
        print(json.dumps(summary) if args.json else summary)
        return EXIT_OK
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        code = _exit_code(exc)
        logger.exception("training failed: %s", exc)
        _emit_error(f"training failed: {exc} (exit {code})")
        return code


def _build_decode_stack(cfg, device, logger):
    """Adapter + (optional) tokenizer + model on ``device``."""
    from .registry import get_model_adapter, initialize_registries

    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
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


def _load_decode_params(cfg, model, from_spec: str, decode_param_dtype: str, logger):
    """Checkpoint → decode-ready model: resolve the spec, load the params
    (warning on a config mismatch), cast for decode."""
    import yaml

    from .training.checkpoint import load_inference_params, resolve_resume_path

    ckpt_path = resolve_resume_path(from_spec, cfg.output.root_dir)
    expected_yaml = yaml.safe_dump(cfg.model_dump(), sort_keys=False)
    step = load_inference_params(ckpt_path, model, expected_config_yaml=expected_yaml)
    logger.info("loaded checkpoint %s (step %d)", ckpt_path, step)
    return prepare_decode_model(model, decode_param_dtype, logger), ckpt_path, step


def _group_seed(seed: int, group: int) -> int:
    """A distinct, reproducible generator seed per prompt-length group
    (the JAX CLI folds the group into its key)."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, group]).generate_state(1, np.uint64)[0])


def _handle_generate(args: argparse.Namespace) -> int:
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_inference_flags(args, cfg)
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

        model, ckpt_path, step = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger
        )
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
        return _exit_code(exc)
    return EXIT_OK


def _unported_serving_flags(args: argparse.Namespace, cfg) -> str | None:
    """The first serving feature asked for that this port does not run
    (serve and serve-bench)."""
    unported = _unported_inference_flags(args, cfg)
    if unported is None and (getattr(args, "router", False) or getattr(args, "backends", None)
                             or getattr(args, "discover", None) or args.replicas):
        unported = f"the replica router {_NOT_PORTED} (ROADMAP.md queue A: replica router)"
    if unported is None and getattr(args, "trace_dir", None) is not None:
        unported = f"--trace-dir (request tracing) {_NOT_PORTED} (ROADMAP.md queue A: telemetry)"
    return unported


def _build_serving_backend(cfg, model, logger):
    """Continuous-batching scheduler + metrics registry for serve and
    serve-bench (JAX ``_build_serving_backend``, policy ``paged``).
    ``serving.policy: speculative`` raises NotImplementedError (exit 2)."""
    from .serving import ContinuousBatchingScheduler, OverloadController, PagedDecodeEngine
    from .telemetry.registry import MetricsRegistry

    scfg = cfg.serving
    registry = MetricsRegistry()
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
    engine = PagedDecodeEngine(
        model,
        block_tokens=scfg.block_tokens,
        num_blocks=scfg.num_blocks or None,
        max_batch_slots=scfg.max_batch_slots,
        prompt_buckets=scfg.prompt_buckets or None,
        batch_buckets=scfg.batch_buckets or None,
        prefix_cache=scfg.prefix_cache,
        prefill_chunk=scfg.prefill_chunk,
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
        engine, registry=registry, policy=scfg.policy, overload=overload
    )
    return scheduler, registry


def _handle_serve(args: argparse.Namespace) -> int:
    """Checkpoint → HTTP server (serving/). ``serving.mode: continuous``
    (or ``--mode continuous``) swaps the one-decode-at-a-time device lock
    for the paged-KV continuous-batching scheduler: handler threads submit
    into the admission queue and in-flight sequences share each decode
    step; ``POST /reload`` hot-swaps a checkpoint under live traffic."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_serving_flags(args, cfg)
    if unported is not None:
        _emit_error(unported)
        return EXIT_CONFIG_ERROR
    mode = args.mode or cfg.serving.mode

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    scheduler = None
    try:
        from .distributed import resolve_device
        from .serving import ClientRateGate, ServerState, make_server
        from .telemetry.registry import MetricsRegistry

        device = resolve_device(cfg.run.device)
        _, tokenizer, model = _build_decode_stack(cfg, device, logger)
        model, ckpt_path, step = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger
        )
        eos = args.eos_token_id
        if eos is None and tokenizer is not None:
            eos = getattr(tokenizer, "eot_token", None)
        if mode == "continuous":
            try:
                scheduler, registry = _build_serving_backend(cfg, model, logger)
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
            # checkpoint) into a second model (a copy of the serving one,
            # already on the device and in the decode dtype) and swaps it
            # in without dropping a request — in-flight sequences finish
            # on the model they were admitted under, new admissions use
            # the new one.
            def _reload(body: dict) -> dict:
                import copy

                spec = str(body.get("from") or args.from_spec)
                new_model, new_ckpt, new_step = _load_decode_params(
                    cfg, copy.deepcopy(state.model), spec, args.decode_param_dtype, logger
                )
                scheduler.hot_swap(new_model, step=new_step, checkpoint=str(new_ckpt))
                state.model = new_model
                state.step, state.checkpoint = new_step, str(new_ckpt)
                return {"step": new_step, "checkpoint": str(new_ckpt)}

            state.reloader = _reload

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
                    "router": None,
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
        return _exit_code(exc)
    finally:
        if scheduler is not None:
            scheduler.close()


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
    compile_block = block["compile"]
    if not compile_block["within_budget"]:
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
    ``generate()``'s. report.json/report.md and the Perfetto trace need the
    telemetry report (ROADMAP.md queue A: telemetry): their keys print
    null."""
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_serving_flags(args, cfg)
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
            cfg, model, args.from_spec, args.decode_param_dtype, logger
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
        try:
            scheduler, _ = _build_serving_backend(cfg, model, logger)
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
        failures = _bench_failures(block, args)
        if args.verify_parity:
            block["parity"] = _verify_parity(model, requests, logger)
            if block["parity"]["mismatched"]:
                failures.append(
                    f"{block['parity']['mismatched']}/{block['parity']['checked']} "
                    "requests diverged from sequential generate()"
                )
        summary = {
            "serving": block,
            "report_json": None,
            "report_md": None,
            "trace_json": None,
            "trace_dir": None,
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
        return _exit_code(exc)
    finally:
        if scheduler is not None:
            scheduler.close()


def _warn_unknown_extras(cfg) -> None:
    """Typos in ``model.extra`` are warnings, never errors."""
    try:
        from .registry import get_model_adapter, initialize_registries

        initialize_registries()
        known = get_model_adapter(cfg.model.name).known_extra_keys
    except Exception:  # noqa: BLE001 — the check must never break validation
        return
    unknown = sorted(set(cfg.model.extra) - set(known or cfg.model.extra))
    if unknown:
        print(
            f"warning: model.extra keys not recognized by '{cfg.model.name}': "
            f"{', '.join(unknown)} (typo? they will be ignored)",
            file=sys.stderr,
        )


def _handle_validate(args: argparse.Namespace) -> int:
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
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


_HANDLERS = {
    "train": _handle_train,
    "generate": _handle_generate,
    "serve": _handle_serve,
    "serve-bench": _handle_serve_bench,
    "validate": _handle_validate,
    "print-config": _handle_print_config,
}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return _HANDLERS[args.command](args)


__all__ = ["build_parser", "main", "prepare_decode_model"]
