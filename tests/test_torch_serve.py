"""The port's simple-mode server and generate CLI against the JAX package.

A tiny byte-tokenizer GPT is saved by the JAX CheckpointManager; the port
loads it through its own CLI helpers and serves it over HTTP on port 0 (CPU).
Greedy completions must equal JAX generate() for the same weights, and a
request whose prompt + max_new_tokens exceeds block_size gets the JAX
server's 400; the generate CLI covers the re-forward branch.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from torch_port_helpers import port_env, random_params, run_cli

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
    """What the refusal of ``--ema`` became: on a checkpoint trained
    without ``trainer.extra.ema_decay`` both CLIs answer ``generate --ema``
    with the same exit code and error."""
    cfg_path, ckpt_path, _, _ = trained
    argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt_path),
            "--prompt-ids", "1,2", *extra]
    answers = []
    for main in (jax_cli.main, cli.main):
        code = run_cli(main, argv)
        answers.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])))
    assert answers[0] == answers[1] and answers[0][0] != 0, answers
    assert "holds no EMA state" in answers[0][1]["error"]


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


@pytest.mark.parametrize(
    "extra",
    [["--router"], ["--mode", "continuous", "--backends", "http://127.0.0.1:1",
                    "--discover", "127.0.0.1:1"]],
    ids=["router-simple-mode", "backends-and-discover"],
)
def test_continuous_serve_exits_2(trained, capsys, extra) -> None:
    """The router runs (test_router_serve_subprocess); what JAX's serve
    refuses of its flags still exits 2 with JAX's message: ``--router``
    without the continuous backend, ``--backends`` with ``--discover``."""
    cfg_path, ckpt_path, _, _ = trained
    argv = ["serve", "--config", str(cfg_path), "--from", str(ckpt_path), *extra]
    answers = []
    for main in (jax_cli.main, cli.main):
        code = run_cli(main, argv)
        answers.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])))
    assert answers[0] == answers[1] and answers[0][0] == 2, answers


def test_router_serve_subprocess(trained, tmp_path) -> None:
    """`serve --mode continuous --router --replicas 2 --trace-dir D` in a
    subprocess: the ready line names 2 replicas, greedy answers equal JAX's
    generate(), POST /reload rolls both replicas (their epochs advance in
    /healthz's router block), and D holds the router's and each replica's
    timeline and a metrics.prom snapshot with exemplar trace ids."""
    cfg_path, ckpt_path, jm, params = trained
    cont = tmp_path / "router.yaml"
    cont.write_text(cfg_path.read_text()
                    + "serving: {mode: continuous, max_batch_slots: 2, block_tokens: 8}\n")
    trace_dir = tmp_path / "traces"
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "serve", "--config", str(cont), "--from",
         str(ckpt_path), "--router", "--replicas", "2", "--port", "0", "--trace-dir",
         str(trace_dir)],
        env=port_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["policy"] == "router" and ready["router"] == 2
        base = f"http://127.0.0.1:{ready['port']}"
        rng = np.random.default_rng(8)
        for n in (5, 12, 20):
            ids = rng.integers(0, 256, n).astype(np.int32)
            code, raw = _request(f"{base}/v1/generate", json.dumps(
                {"prompt_ids": ids.tolist(), "max_new_tokens": 6, "temperature": 0}).encode())
            out = json.loads(raw)
            assert code == 200 and len(out["trace_id"]) == 32
            want = jax_generate(jm, params, ids[None], max_new_tokens=6, temperature=0.0)
            assert out["completion_ids"] == np.asarray(want)[0, n:].tolist()
        code, raw = _request(f"{base}/reload", b"{}")
        reloaded = json.loads(raw)
        assert code == 200 and [r["replica"] for r in reloaded["replicas"]] == [
            "replica0", "replica1"]
        deadline = time.monotonic() + 60
        while True:  # each swap applies between its scheduler's steps
            fleet = json.loads(_request(f"{base}/healthz")[1])["scheduler"]["router"]
            epochs = [r["param_epoch"] for r in fleet["replicas"]]
            if epochs == [1, 1] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert epochs == [1, 1] and fleet["replicas_healthy"] == 2
        assert fleet["requests_routed"] == 3 and fleet["epoch_divergence"] == 0
    finally:
        proc.send_signal(signal.SIGINT)  # a clean stop writes the last snapshot
        proc.wait(timeout=60)
    for name in ("router", "replica0", "replica1"):
        assert (trace_dir / name / "timeline.jsonl").is_file(), name
    prom = (trace_dir / "metrics.prom").read_text()
    assert "llmtrain_router_replicas_healthy" in prom and '# {trace_id="' in prom
