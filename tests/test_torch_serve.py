"""The port's simple-mode server and generate CLI against the JAX package.

A tiny byte-tokenizer GPT is saved by the JAX CheckpointManager; the port
loads it through its own CLI helpers and serves it over HTTP on port 0 (CPU).
Greedy completions must equal JAX generate() for the same weights, and a
request whose prompt + max_new_tokens exceeds block_size gets the JAX
server's 400; the generate CLI covers the re-forward branch.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from torch_port_helpers import random_params, run_cli

from llmtrain_tpu import cli as jax_cli
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu.generation import generate as jax_generate
from llmtrain_tpu.registry import get_model_adapter, initialize_registries
from llmtrain_tpu.serving.http import ServerState as JaxServerState
from llmtrain_tpu.serving.http import _handle_generate_request as jax_handle_generate
from llmtrain_tpu.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch import cli
from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.distributed import resolve_device
from llmtrain_tpu_torch.serving import ServerState, make_server
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry
from llmtrain_tpu_torch.utils.logging import get_logger

_CONFIG = """\
run: {name: serve-test, device: cpu, seed: 5}
model:
  name: gpt
  block_size: 32
  d_model: 32
  n_layers: 2
  n_heads: 2
  d_ff: 64
  dropout: 0.0
  attention: flash
  extra: {tokenizer: byte}
data: {name: dummy_text}
trainer: {max_steps: 1, warmup_steps: 0}
logging: {level: WARNING}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(config path, checkpoint path, JAX model, JAX params)."""
    root = tmp_path_factory.mktemp("serve")
    cfg_path = root / "tiny.yaml"
    cfg_path.write_text(_CONFIG)
    cfg, _, resolved = jax_load(cfg_path)
    initialize_registries()
    model = get_model_adapter("gpt")().build_model(cfg)
    params = random_params(model, jnp.zeros((1, 32), jnp.int32), seed=31)
    host = {"params": serialization.to_state_dict(params), "opt_state": {}}
    ckpt = CheckpointManager(root / "ckpts").save_host(4, host, resolved)
    return cfg_path, ckpt, model, params


@pytest.fixture(scope="module")
def server(trained):
    cfg_path, ckpt_path, _, _ = trained
    cfg, _, _ = load_and_validate_config(cfg_path)
    logger = get_logger()
    _, tokenizer, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device), logger)
    model, path, step = cli._load_decode_params(cfg, model, str(ckpt_path), "compute", logger)
    state = ServerState(model=model, tokenizer=tokenizer, step=step, checkpoint=str(path),
                        registry=MetricsRegistry())
    httpd = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(url: str, body: bytes | None = None) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


@pytest.mark.parametrize("prompt_len, max_new", [(10, 8), (20, 20)], ids=["cache", "reforward"])
def test_greedy_completion_matches_jax_generate(trained, server, prompt_len, max_new) -> None:
    _, ckpt_path, jm, params = trained
    ids = np.random.default_rng(prompt_len).integers(0, 256, prompt_len).astype(np.int32)
    body = {"prompt_ids": ids.tolist(), "max_new_tokens": max_new, "temperature": 0}
    code, raw = _request(f"{server}/v1/generate", json.dumps(body).encode())
    if prompt_len + max_new > 32:  # over block_size: the JAX server's 400, word for word
        jax_state = JaxServerState(model=jm, params=params, tokenizer=None, step=4,
                                   checkpoint=str(ckpt_path))
        jax_code, jax_resp = jax_handle_generate(jax_state, body)
        assert (code, json.loads(raw)) == (jax_code, jax_resp) and code == 400
        return
    assert code == 200, raw
    expected = jax_generate(jm, params, ids[None], max_new_tokens=max_new, temperature=0.0)
    assert json.loads(raw)["completion_ids"] == np.asarray(expected)[0, prompt_len:].tolist()


def test_health_metrics_and_bad_requests(server) -> None:
    code, raw = _request(f"{server}/v1/generate",
                         json.dumps({"prompt": "hi", "max_new_tokens": 2}).encode())
    assert code == 200 and isinstance(json.loads(raw)["text"], str)
    code, raw = _request(f"{server}/healthz")
    assert code == 200 and json.loads(raw)["status"] == "ok"
    code, raw = _request(f"{server}/metrics")
    assert code == 200 and b"llmtrain_serve_requests_total" in raw
    for bad in (b"{not json", json.dumps({"prompt_ids": "x"}).encode(),
                json.dumps({"prompt_ids": [1], "bogus": 1}).encode()):
        code, raw = _request(f"{server}/v1/generate", bad)
        assert code == 400 and "error" in json.loads(raw)


def test_generate_cli_matches_jax_cli(trained, capsys) -> None:
    cfg_path, ckpt_path, _, _ = trained
    argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt_path),
            "--prompt-ids", "3,1,4,1,5,9,2,6", "--max-new-tokens", "30",
            "--temperature", "0", "--logprobs", "--json"]
    assert run_cli(jax_cli.main, argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert run_cli(cli.main, argv) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["output_ids"] == theirs["output_ids"]
    assert ours["step"] == theirs["step"] == 4
    np.testing.assert_allclose(ours["logprobs"], theirs["logprobs"], atol=2e-6, rtol=0)


@pytest.mark.parametrize("extra", [["--ema"]], ids=["ema"])
def test_unported_generate_flags_exit_2(trained, capsys, extra) -> None:
    cfg_path, ckpt_path, _, _ = trained
    argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt_path),
            "--prompt-ids", "1,2", *extra]
    assert run_cli(cli.main, argv) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


@pytest.mark.parametrize(
    "extra",
    [["--quantize", "int8"], ["--draft-config", "{cfg}", "--draft-from", "{ckpt}"]],
    ids=["quantize", "draft"],
)
def test_generate_flags_match_jax_cli(trained, capsys, extra) -> None:
    """What the refusals of these flags became: the same generate with
    --quantize int8, or with the checkpoint as its own draft, emits the
    JAX CLI's ids (greedy; the draft reproduces the target's greedy)."""
    cfg_path, ckpt_path, _, _ = trained
    extra = [a.format(cfg=cfg_path, ckpt=ckpt_path) for a in extra]
    argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt_path),
            "--prompt-ids", "1,2", "--max-new-tokens", "20", "--temperature", "0", "--json",
            *extra]
    assert run_cli(jax_cli.main, argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert run_cli(cli.main, argv) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["output_ids"] == theirs["output_ids"] and len(ours["completion_ids"]) == 20


def test_continuous_serve_exits_2(trained, capsys) -> None:
    """Continuous mode runs (tests/test_torch_serve_bench.py); what it
    does not run yet still exits 2: the replica router in front of it."""
    cfg_path, ckpt_path, _, _ = trained
    argv = ["serve", "--config", str(cfg_path), "--from", str(ckpt_path), "--mode", "continuous",
            "--router"]
    assert run_cli(cli.main, argv) == 2
    assert "not yet ported" in capsys.readouterr().err
