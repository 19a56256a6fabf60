"""The port's speculative decoding against the JAX package's.

Tiny GPTs (target: 2 layers, d 64, 4 heads; draft: 1 layer, d 32) in f32
with the same weights on both sides (interop/flax_params.py):

* greedy ``speculative_generate`` emits JAX's tokens and the port's own
  ``generate()`` greedy tokens: a self-draft that accepts everything (one
  target call per gamma + 1 tokens), a weak draft, gamma 1/3/5, eos, a
  single-token prompt, a GQA target, a rolling-window target and int8
  decode caches (JAX's tests/test_speculative.py and
  tests/test_quant.py cases);
* sampled decoding: the first token's marginal over many seeds matches
  the analytic filtered target distribution (JAX's
  ``test_marginal_matches_analytic_target``; the draws come from a
  torch.Generator, so the streams differ from JAX's); filters compose;
  out-of-band knobs mean disabled;
* JAX's validation: batch 1, gamma >= 1, the block_size bound, 0 new
  tokens;
* the CLI: ``python -m llmtrain_tpu_torch generate --draft-config ...``
  in a subprocess emits JAX's CLI ids on the same checkpoints; unpaired
  draft flags, ``--logprobs`` with a draft and a draft of another
  vocabulary exit 2 with JAX's messages.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import jax_gpt, port_env, port_gpt, random_params, run_cli, seeded_ids

from llmtrain_tpu import cli as jax_cli
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu.registry import get_model_adapter, initialize_registries
from llmtrain_tpu.speculative import _filtered_logprobs as jax_filtered_logprobs
from llmtrain_tpu.speculative import speculative_generate as jax_speculative
from llmtrain_tpu.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch import cli
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.speculative import _filtered_logprobs, speculative_generate

VOCAB = 61
PROMPT = seeded_ids(50, (1, 5), VOCAB)
DRAFT = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64)


def _pair(seed: int, draft_seed: int | None = None, **target_kw):
    """(JAX target, params, port target, JAX draft, params, port draft); the
    draft is the target itself when ``draft_seed`` is None."""
    jm, params = jax_gpt(seed=seed, **target_kw)
    tm = port_gpt(jm, params)
    if "kv_cache_dtype" in target_kw:
        tm.kv_cache_dtype = target_kw["kv_cache_dtype"]
    if draft_seed is None:
        return jm, params, tm, jm, params, tm
    jd, dparams = jax_gpt(seed=draft_seed, **DRAFT)
    return jm, params, tm, jd, dparams, port_gpt(jd, dparams)


def _greedy_case(pair, prompt, *, max_new_tokens, gamma, eos=None):
    jm, params, tm, jd, dparams, td = pair
    theirs = jax_speculative(jm, params, jd, dparams, prompt, max_new_tokens=max_new_tokens,
                             gamma=gamma, eos_token_id=eos)
    ours, stats = speculative_generate(tm, td, prompt, max_new_tokens=max_new_tokens,
                                       gamma=gamma, eos_token_id=eos, return_stats=True)
    plain = generate(tm, prompt, max_new_tokens=max_new_tokens, temperature=0.0,
                     eos_token_id=eos)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_array_equal(ours, plain)
    assert ours.dtype == np.int32 and ours.shape == (1, prompt.shape[1] + max_new_tokens)
    return ours, stats


_GREEDY = [("self-draft", 1, None, 4, {}),
           ("weak-draft", 2, 3, 4, {}),
           ("gamma1", 4, 5, 1, {}),
           ("gamma3", 4, 5, 3, {}),
           ("gamma5", 4, 5, 5, {}),
           ("gqa", 6, 7, 3, {"n_kv_heads": 2}),
           ("rolling", 8, 9, 3, {"sliding_window": 6}),
           ("int8-cache", 10, 11, 3, {"kv_cache_dtype": "int8"}),
           ("rolling-int8", 12, 13, 2, {"sliding_window": 6, "kv_cache_dtype": "int8"})]


@pytest.mark.parametrize("name, seed, draft_seed, gamma, target_kw", _GREEDY,
                         ids=[c[0] for c in _GREEDY])
def test_greedy_matches_jax_and_generate(name, seed, draft_seed, gamma, target_kw) -> None:
    pair = _pair(seed, draft_seed, **target_kw)
    _, stats = _greedy_case(pair, PROMPT, max_new_tokens=20, gamma=gamma)
    if draft_seed is None:
        # A self-draft agrees every time: one target call per gamma + 1.
        assert stats == {"target_forwards": math.ceil(20 / (gamma + 1)),
                         "mean_accepted": pytest.approx(20 / math.ceil(20 / (gamma + 1)) - 1,
                                                        abs=1e-4)}


def test_single_token_prompt() -> None:
    _greedy_case(_pair(14, 15), PROMPT[:, :1], max_new_tokens=12, gamma=3)


@pytest.mark.parametrize("gamma", [1, 4])
def test_eos_stop_matches_plain(gamma: int) -> None:
    """eos taken from the plain greedy stream, so it is emitted mid-way: the
    rest is eos, as generate() fills it."""
    pair = _pair(16, 17)
    plain = generate(pair[2], PROMPT, max_new_tokens=16, temperature=0.0)
    eos = int(plain[0, PROMPT.shape[1] + 6])
    out, _ = _greedy_case(pair, PROMPT, max_new_tokens=16, gamma=gamma, eos=eos)
    tail = out[0, PROMPT.shape[1]:]
    first = int(np.argmax(tail == eos))
    assert (tail[first:] == eos).all()


def test_marginal_matches_analytic_target() -> None:
    """The first sampled token over 600 seeds against the analytic filtered
    target distribution (top-k 4 concentrates the mass: noise-only total
    variation at n=600 is ~0.03, a biased acceptance rule an order of
    magnitude more)."""
    jm, params = jax_gpt(seed=18, n_layers=1, d_model=16, n_heads=4, d_ff=64)
    jd, dparams = jax_gpt(seed=19, n_layers=1, d_model=16, n_heads=4, d_ff=64)
    tm, td = port_gpt(jm, params), port_gpt(jd, dparams)
    logits = jm.apply({"params": params}, jnp.asarray(PROMPT), deterministic=True)
    analytic = np.exp(np.asarray(jax_filtered_logprobs(
        logits[:, -1].astype(jnp.float32), temperature=1.0, top_k=4, top_p=None)[0]))
    with torch.no_grad():
        ours = _filtered_logprobs(tm(torch.from_numpy(PROMPT).long())[:, -1], temperature=1.0,
                                  top_k=4, top_p=None)[0].exp().numpy()
    np.testing.assert_allclose(ours, analytic, atol=1e-6)
    n = 600
    counts = np.zeros(VOCAB)
    gen = torch.Generator()
    for s in range(n):
        gen.manual_seed(s)
        out = speculative_generate(tm, td, PROMPT, max_new_tokens=1, gamma=2, temperature=1.0,
                                   top_k=4, generator=gen)
        counts[int(out[0, PROMPT.shape[1]])] += 1
    tv = 0.5 * np.abs(counts / n - analytic).sum()
    assert tv < 0.08, f"total variation vs analytic {tv:.3f}"


def test_sampled_filters_compose_and_out_of_band_knobs_disable() -> None:
    _, _, tm, _, _, td = _pair(20, 21)

    def run(**kw):
        gen = torch.Generator()
        gen.manual_seed(7)
        return speculative_generate(tm, td, PROMPT, max_new_tokens=8, gamma=3,
                                    temperature=0.8, generator=gen, **kw)

    out = run(top_k=8, top_p=0.9)
    assert out.shape == (1, PROMPT.shape[1] + 8) and ((out >= 0) & (out < VOCAB)).all()
    np.testing.assert_array_equal(run(top_k=0, top_p=0.0), run(top_k=None, top_p=None))
    np.testing.assert_array_equal(run(top_p=1.0), run())


def test_validation_matches_jax() -> None:
    jm, params, tm, jd, dparams, td = _pair(22, 23)
    cases = [
        (np.zeros((2, 3), np.int32), dict(max_new_tokens=4)),
        (PROMPT, dict(max_new_tokens=4, gamma=0)),
        (PROMPT, dict(max_new_tokens=30, gamma=4)),
    ]
    for prompt, kw in cases:
        with pytest.raises(ValueError) as theirs:
            jax_speculative(jm, params, jd, dparams, prompt, **kw)
        with pytest.raises(ValueError) as ours:
            speculative_generate(tm, td, prompt, **kw)
        assert str(ours.value) == str(theirs.value)
    out, stats = speculative_generate(tm, td, PROMPT, max_new_tokens=0, return_stats=True)
    np.testing.assert_array_equal(out, PROMPT)
    assert stats == {"target_forwards": 0, "mean_accepted": 0.0}


# --------------------------------------------------------------- the CLI

def _checkpoint(root: Path, name: str, model_kw: dict, seed: int) -> tuple[Path, Path]:
    """A tiny byte-vocab GPT config and a JAX checkpoint of seeded params."""
    raw = {
        "run": {"name": name, "seed": 0, "device": "cpu"},
        "model": {"name": "gpt", "block_size": 64, "dropout": 0.0, "vocab_size": VOCAB,
                  "attention": "dense", **model_kw},
        "data": {"name": "dummy_text"},
        "trainer": {"max_steps": 1, "warmup_steps": 0},
        "logging": {"level": "WARNING"},
        "mlflow": {"enabled": False},
        "telemetry": {"enabled": False},
        "output": {"root_dir": str(root / "runs")},
    }
    cfg_path = root / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, resolved = jax_load(cfg_path)
    initialize_registries()
    model = get_model_adapter("gpt")().build_model(cfg)
    params = random_params(model, jnp.zeros((1, 64), jnp.int32), seed=seed)
    host = {"params": serialization.to_state_dict(params), "opt_state": {}}
    return cfg_path, CheckpointManager(root / f"{name}_ckpts").save_host(2, host, resolved)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec_cli")
    target = _checkpoint(root, "target", dict(d_model=64, n_layers=2, n_heads=4, d_ff=128), 24)
    draft = _checkpoint(root, "draft", dict(d_model=32, n_layers=1, n_heads=2, d_ff=64), 25)
    other = _checkpoint(root, "other", dict(d_model=32, n_layers=1, n_heads=2, d_ff=64,
                                            vocab_size=59), 26)
    return root, target, draft, other


def _port_subprocess(argv: list[str], cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", *argv], cwd=cwd,
                          env=port_env(), capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"]], ids=["bf", "int8"])
def test_generate_with_draft_subprocess_matches_jax_cli(checkpoints, capsys, extra) -> None:
    root, (tcfg, tckpt), (dcfg, dckpt), _ = checkpoints
    argv = ["generate", "--config", str(tcfg), "--from", str(tckpt), "--draft-config",
            str(dcfg), "--draft-from", str(dckpt), "--gamma", "3", "--prompt-ids",
            "3,1,4,1,5,9", "--max-new-tokens", "24", "--temperature", "0", "--json", *extra]
    proc = _port_subprocess(argv, root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ours = json.loads(proc.stdout.strip().splitlines()[-1])
    assert run_cli(jax_cli.main, argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["output_ids"] == theirs["output_ids"]
    assert ours["step"] == theirs["step"] == 2
    # The target alone, greedy: the same tokens.
    plain = [a for a in argv if a not in ("--draft-config", str(dcfg), "--draft-from",
                                          str(dckpt), "--gamma", "3")]
    assert run_cli(cli.main, plain) == 0
    assert json.loads(capsys.readouterr().out.strip())["output_ids"] == ours["output_ids"]


@pytest.mark.parametrize("case", ["unpaired", "logprobs", "vocab", "gamma", "too-long"])
def test_generate_draft_errors_match_jax(checkpoints, capsys, case) -> None:
    _, (tcfg, tckpt), (dcfg, dckpt), (ocfg, ockpt) = checkpoints
    base = ["generate", "--config", str(tcfg), "--from", str(tckpt), "--prompt-ids", "1,2",
            "--max-new-tokens", "8"]
    extra = {
        "unpaired": ["--draft-config", str(dcfg)],
        "logprobs": ["--draft-config", str(dcfg), "--draft-from", str(dckpt), "--logprobs"],
        "vocab": ["--draft-config", str(ocfg), "--draft-from", str(ockpt)],
        "gamma": ["--draft-config", str(dcfg), "--draft-from", str(dckpt), "--gamma", "0"],
        "too-long": ["--draft-config", str(dcfg), "--draft-from", str(dckpt),
                     "--max-new-tokens", "60"],
    }[case]
    assert run_cli(jax_cli.main, base + extra) == 2
    theirs = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]
    assert run_cli(cli.main, base + extra) == 2
    ours = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]
    assert ours == theirs
