"""Command-line interface of the port: ``python -m llmtrain_tpu_torch``.

Same subcommands, flags, JSON shapes and exit codes as the JAX CLI
(``llmtrain_tpu/cli.py``) for the surface this slice ports:

* ``train`` — config → run directory (``config.yaml``, ``meta.json``,
  ``logs/``, ``checkpoints/``) → the trainer (training/trainer.py), with
  ``--run-id``, ``--dry-run``, ``--json``, ``-v``, ``--resume`` and
  ``--auto-resume``; the run summary on stdout;
* ``generate`` — checkpoint → ``generate()`` (KV-cache or re-forward branch);
* ``serve`` — checkpoint → simple-mode HTTP server (serving/http.py);
* ``validate`` / ``print-config`` — the config loader.

Exit codes: 0 ok, 1 failure, 2 config error (a feature that is not yet
ported counts as a config error). Flags whose feature is not
yet ported (``--ema``, ``--draft-*``, ``--quantize int8``, continuous
mode, the router, ``--trace-dir``) and LoRA or pipeline checkpoints exit
2 with a message naming the ROADMAP.md item. ``run.device`` (default
``cuda``) picks the
device: ``cpu`` the CPU, ``tpu``/``cuda`` the card (an error when none is
visible).
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
        help="override serving.mode ('continuous' not yet ported)",
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
            "(ROADMAP.md queue A: continuous serving)"
        )
    if args.quantize != "none":
        return (
            f"--quantize {args.quantize} {_NOT_PORTED} "
            "(ROADMAP.md queue A: continuous serving)"
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


def _handle_serve(args: argparse.Namespace) -> int:
    cfg, code = _load_config(args.config)
    if cfg is None:
        return code
    unported = _unported_inference_flags(args, cfg)
    mode = args.mode or cfg.serving.mode
    if unported is None and mode != "simple":
        unported = (
            f"serving.mode {mode!r} (paged engine, scheduler) {_NOT_PORTED} "
            "(ROADMAP.md queue A: continuous serving); use simple mode"
        )
    if unported is None and (args.router or args.backends or args.discover or args.replicas):
        unported = f"the replica router {_NOT_PORTED} (ROADMAP.md queue A: continuous serving)"
    if unported is None and args.trace_dir is not None:
        unported = f"--trace-dir (request tracing) {_NOT_PORTED} (ROADMAP.md queue A: telemetry)"
    ocfg = cfg.serving.overload
    if unported is None and ocfg.enabled and ocfg.client_rate_rps > 0:
        unported = (
            f"per-client rate limiting (serving.overload) {_NOT_PORTED} "
            "(ROADMAP.md queue A: continuous serving)"
        )
    if unported is not None:
        _emit_error(unported)
        return EXIT_CONFIG_ERROR

    from .utils.logging import configure_logging

    logger = configure_logging(level=cfg.logging.level, json_output=cfg.logging.json_output)
    try:
        from .distributed import resolve_device
        from .serving import ServerState, make_server
        from .telemetry.registry import MetricsRegistry

        device = resolve_device(cfg.run.device)
        _, tokenizer, model = _build_decode_stack(cfg, device, logger)
        model, ckpt_path, step = _load_decode_params(
            cfg, model, args.from_spec, args.decode_param_dtype, logger
        )
        eos = args.eos_token_id
        if eos is None and tokenizer is not None:
            eos = getattr(tokenizer, "eot_token", None)
        cap = (
            args.max_new_tokens_cap
            if args.max_new_tokens_cap is not None
            else cfg.serving.max_new_tokens_cap
        )
        state = ServerState(
            model=model,
            tokenizer=tokenizer,
            step=step,
            checkpoint=str(ckpt_path),
            eos_token_id=eos,
            max_new_tokens_cap=cap,
            default_max_new_tokens=cfg.serving.default_max_new_tokens,
            registry=MetricsRegistry(),
        )
        httpd = make_server(state, args.host, args.port)
        host, port = httpd.server_address[:2]
        # Machine-readable ready line: the bound port (--port 0) is read here.
        print(
            json.dumps(
                {
                    "serving": str(ckpt_path),
                    "host": host,
                    "port": port,
                    "mode": "simple",
                    "policy": None,
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
    "validate": _handle_validate,
    "print-config": _handle_print_config,
}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return _HANDLERS[args.command](args)


__all__ = ["build_parser", "main", "prepare_decode_model"]
