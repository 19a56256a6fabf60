"""The port's serve-bench, its load generator and `serve --mode continuous`
against the JAX package's.

A tiny GQA GPT checkpoint is saved by the JAX CheckpointManager; both CLIs
load it on the CPU:

* ``build_requests`` gives JAX's population for a seed (prompts, seeds,
  knobs, priorities), whatever the mix knobs;
* ``python -m llmtrain_tpu_torch serve-bench --verify-parity`` exits 0 in a
  subprocess, with JAX's summary keys, bitwise parity and the shapes
  within budget; a sampled run with the prefix cache and chunked prefill
  too;
* ``serve --mode continuous`` in a subprocess: greedy answers equal JAX's
  generate(), /healthz shows the scheduler, /metrics its gauges, POST
  /reload hot-swaps, and overload control answers a burst with 429 +
  Retry-After (the counterparts of tests/test_serving.py's continuous
  backend and live-server tests);
* in process: a failed request is a 500 while the scheduler keeps
  serving, and a dead scheduler loop turns /healthz to 503.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from flax import serialization
from torch_port_helpers import random_params, run_cli

from llmtrain_tpu import cli as jax_cli
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu.generation import generate as jax_generate
from llmtrain_tpu.registry import get_model_adapter, initialize_registries
from llmtrain_tpu.serving import build_requests as jax_build_requests
from llmtrain_tpu.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch import cli
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.distributed import resolve_device
from llmtrain_tpu_torch.serving import ServerState, ServeRequest, build_requests, make_server
from llmtrain_tpu_torch.utils.logging import get_logger

_ROOT = Path(__file__).resolve().parents[1]
_CONFIG = {
    "run": {"name": "sbench", "seed": 0, "device": "cpu"},
    "model": {"name": "gpt", "block_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
              "d_ff": 128, "dropout": 0.0, "vocab_size": 61, "attention": "dense",
              "extra": {"n_kv_heads": 2}},
    "data": {"name": "dummy_text"},
    "trainer": {"max_steps": 1, "warmup_steps": 0},
    "serving": {"mode": "continuous", "max_batch_slots": 4, "block_tokens": 8,
                "batch_buckets": [2, 4]},
    "logging": {"level": "WARNING"},
    "mlflow": {"enabled": False},
    "telemetry": {"enabled": False},
}


def _write_config(root: Path, name: str, **serving) -> Path:
    raw = json.loads(json.dumps(_CONFIG))
    raw["serving"].update(serving)
    raw["output"] = {"root_dir": str(root / "runs")}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(root, config path, checkpoint path, JAX model, JAX params)."""
    root = tmp_path_factory.mktemp("sbench")
    cfg_path = _write_config(root, "tiny")
    cfg, _, resolved = jax_load(cfg_path)
    initialize_registries()
    model = get_model_adapter("gpt")().build_model(cfg)
    params = random_params(model, jnp.zeros((1, 64), jnp.int32), seed=41)
    host = {"params": serialization.to_state_dict(params), "opt_state": {}}
    ckpt = CheckpointManager(root / "ckpts").save_host(3, host, resolved)
    return root, cfg_path, ckpt, model, params


_POPULATIONS = {
    "plain": dict(),
    "sampled": dict(temperature=0.8, top_k=5, top_p=0.9, eos_token_id=3),
    "shared-prefix": dict(shared_prefix_tokens=12, shared_prefix_count=3),
    "long-mix": dict(long_fraction=0.3, long_prompt_tokens=40),
    "overload-knobs": dict(deadline_ms=250.0, batch_fraction=0.4),
}


@pytest.mark.parametrize("name", sorted(_POPULATIONS))
def test_build_requests_matches_jax(name: str) -> None:
    kw = dict(num_requests=9, seed=17, vocab_size=61, prompt_tokens_min=3,
              prompt_tokens_max=20, max_new_tokens=7, **_POPULATIONS[name])
    fields = ("max_new_tokens", "temperature", "top_k", "top_p", "seed", "eos_token_id",
              "deadline_ms", "priority", "rid")
    ours, theirs = build_requests(**kw), jax_build_requests(**kw)
    assert len(ours) == len(theirs) == 9
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.prompt_ids, t.prompt_ids)
        assert o.prompt_ids.dtype == t.prompt_ids.dtype
        assert [getattr(o, f) for f in fields] == [getattr(t, f) for f in fields]


_BENCH = ["--requests", "8", "--rate-rps", "200", "--seed", "5", "--prompt-tokens-min", "3",
          "--prompt-tokens-max", "30", "--max-new-tokens", "10", "--verify-parity"]


def _port_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serve_bench_subprocess_matches_jax_summary(trained, capsys) -> None:
    root, cfg_path, ckpt, _, _ = trained
    argv = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt), *_BENCH]
    proc = subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", *argv], cwd=root,
                          env=_port_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ours = json.loads(proc.stdout)
    assert run_cli(jax_cli.main, [*argv, "--out", str(root / "jax_bench")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert set(ours) == set(theirs)
    assert ours["report_json"] is ours["report_md"] is ours["trace_json"] is None
    # The serving block: JAX's keys, less the request tracer's (telemetry).
    assert set(ours["serving"]) == set(theirs["serving"]) - {"tracing"}
    block = ours["serving"]
    assert ours["ok"] and block["parity"] == {"checked": 8, "mismatched": 0,
                                              "bitwise_identical": True}
    assert block["compile"]["within_budget"]
    assert block["requests"]["completed"] == 8 and block["occupancy"]["peak"] >= 2
    assert set(block["compile"]) == set(theirs["serving"]["compile"])
    assert set(block["slo"]["ttft_ms"]) == set(theirs["serving"]["slo"]["ttft_ms"])


def test_serve_bench_sampled_prefix_cache_chunked(trained, capsys) -> None:
    root, _, ckpt, _, _ = trained
    cfg_path = _write_config(root, "prefix", prefix_cache=True, prefill_chunk=8)
    argv = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt), *_BENCH,
            "--temperature", "0.8", "--top-k", "7", "--shared-prefix-tokens", "12",
            "--shared-prefix-count", "2"]
    assert run_cli(cli.main, argv) == 0
    block = json.loads(capsys.readouterr().out)["serving"]
    assert block["parity"]["bitwise_identical"] and block["compile"]["within_budget"]
    assert block["prefix_cache"]["hit_rate"] > 0


@pytest.mark.parametrize(
    "extra, cites",
    [(["--requests", "0"], "--requests must be >= 1"),
     (["--router"], "replica router"),
     (["--draft-config", "x.yaml", "--draft-from", "x"], "speculative decoding"),
     (["--quantize", "int8"], "int8 quantization")],
    ids=["bad-requests", "router", "draft", "int8"],
)
def test_serve_bench_refusals_exit_2(trained, capsys, extra, cites) -> None:
    _, cfg_path, ckpt, _, _ = trained
    argv = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt), *extra]
    assert run_cli(cli.main, argv) == 2
    assert cites in capsys.readouterr().err


def _request(url: str, body: object | None = None, timeout: float = 120.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        return exc.code, json.loads(raw) if raw.startswith(b"{") else raw, dict(exc.headers)


def test_continuous_serve_subprocess(trained) -> None:
    root, _, ckpt, jm, params = trained
    cfg_path = _write_config(root, "overload", overload={"enabled": True, "queue_cap": 1})
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "serve", "--config", str(cfg_path),
         "--from", str(ckpt), "--mode", "continuous", "--port", "0"],
        cwd=root, env=_port_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["mode"] == "continuous" and ready["policy"] == "paged"
        base = f"http://127.0.0.1:{ready['port']}"
        rng = np.random.default_rng(42)
        for n in (3, 17, 30):
            ids = rng.integers(0, 61, n).astype(np.int32)
            code, out, _ = _request(f"{base}/v1/generate", {
                "prompt_ids": ids.tolist(), "max_new_tokens": 9, "temperature": 0})
            assert code == 200 and out["finish_reason"] == "length" and out["ttft_ms"] > 0
            want = jax_generate(jm, params, ids[None], max_new_tokens=9, temperature=0.0)
            assert out["completion_ids"] == np.asarray(want)[0, n:].tolist()
        code, health, _ = _request(f"{base}/healthz")
        sched = health["scheduler"]
        assert code == 200 and sched["policy"] == "paged" and sched["requests_finished"] == 3
        assert sched["compile"]["within_budget"] and sched["overload"]["queue_cap"] == 1
        code, reloaded, _ = _request(f"{base}/reload", {})
        assert code == 200 and reloaded["status"] == "ok" and reloaded["step"] == 3
        body = {"prompt_ids": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], "max_new_tokens": 40,
                "temperature": 0}
        with ThreadPoolExecutor(12) as ex:
            burst = list(ex.map(lambda _: _request(f"{base}/v1/generate", body), range(12)))
        rejected = [(c, o, h) for c, o, h in burst if c == 429]
        assert rejected and all(c in (200, 429) for c, _, _ in burst)
        assert all(o["reason"] == "queue_full" and int(h["Retry-After"]) >= 1
                   for _, o, h in rejected)
        code, health, _ = _request(f"{base}/healthz")
        assert health["scheduler"]["params"]["hot_swaps"] == 1
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        assert "llmtrain_serve_kv_pool_utilization" in text
        assert 'llmtrain_serve_rejected_total{reason="queue_full"}' in text
    finally:
        proc.terminate()
        proc.wait(timeout=60)


@pytest.fixture()
def continuous_state(trained):
    _, cfg_path, ckpt, _, _ = trained
    cfg, _, _ = load_and_validate_config(cfg_path)
    logger = get_logger()
    _, tokenizer, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device), logger)
    model, path, step = cli._load_decode_params(cfg, model, str(ckpt), "compute", logger)
    scheduler, registry = cli._build_serving_backend(cfg, model, logger)
    scheduler.start()
    state = ServerState(model=model, tokenizer=tokenizer, step=step, checkpoint=str(path),
                        scheduler=scheduler, registry=registry)
    yield state
    scheduler.close()


def test_request_error_is_500_and_dead_loop_is_503(continuous_state) -> None:
    from llmtrain_tpu_torch.serving.http import _handle_generate_request

    state = continuous_state
    code, out = _handle_generate_request(state, {"prompt_ids": list(range(1, 40)),
                                                  "max_new_tokens": 30})
    assert code == 400 and "block_size" in out["error"]
    bad = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=70)
    state.scheduler.submit(bad)
    assert bad.done.wait(timeout=60) and bad.finish_reason == "error"
    original = state.scheduler.engine.prefill

    def failing(*args, **kwargs):
        raise RuntimeError("injected prefill failure")

    state.scheduler.engine.prefill = failing
    code, out = _handle_generate_request(state, {"prompt_ids": [5, 6], "max_new_tokens": 2})
    assert code == 500 and "injected prefill failure" in out["error"]
    state.scheduler.engine.prefill = original
    code, out = _handle_generate_request(state, {"prompt_ids": [5], "max_new_tokens": 2,
                                                  "temperature": 0})
    assert code == 200  # the scheduler survived

    httpd = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _request(f"{base}/healthz")[0] == 200
        state.scheduler.close()  # the loop thread exits: /healthz must say so
        code, payload, headers = _request(f"{base}/healthz")
        assert code == 503 and payload["status"] == "unhealthy"
        assert int(headers["Retry-After"]) >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
