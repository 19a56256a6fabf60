"""The port's generate() against the JAX generate() with the same weights.

Greedy decoding is token-identical on both branches: KV-cache (prompt +
max_new_tokens <= block_size) and the sliding-window re-forward (total >
block_size, so the window slides), with and without an eos token.
Logprobs agree at atol 1e-5 and filter_logits numerically (f32, summation
order only). Sampled decoding cannot be token-identical (torch.Generator
vs jax.random), so it is checked for reproducibility and filter respect.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY, jax_gpt, port_gpt, seeded_ids

from llmtrain_tpu.generation import filter_logits as jax_filter_logits
from llmtrain_tpu.generation import generate as jax_generate
from llmtrain_tpu_torch.generation import filter_logits, generate


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=11)
    return jm, params, port_gpt(jm, params)


# (prompt length, max_new_tokens): 12+8 fits block_size 32 (KV cache);
# 12+30 = 42 > 32 slides the re-forward window.
@pytest.mark.parametrize(
    "tp, max_new, use_eos, logprobs",
    [
        (12, 8, False, True),
        (12, 8, True, False),
        (12, 30, False, False),
        (12, 30, True, True),
    ],
    ids=["cache", "cache-eos", "reforward", "reforward-eos-logprobs"],
)
def test_greedy_is_token_identical(models, tp, max_new, use_eos, logprobs) -> None:
    jm, params, tm = models
    ids = seeded_ids(12, (2, tp), TINY["vocab_size"])
    eos = None
    if use_eos:
        # A token row 0 emits mid-generation, so eos handling really runs.
        eos = int(generate(tm, ids, max_new_tokens=4, temperature=0.0)[0, tp + 2])
    ours = generate(tm, ids, max_new_tokens=max_new, temperature=0.0,
                    eos_token_id=eos, return_logprobs=logprobs)
    theirs = jax_generate(jm, params, ids, max_new_tokens=max_new, temperature=0.0,
                          eos_token_id=eos, return_logprobs=logprobs)
    if logprobs:
        (ours, our_lp), (theirs, their_lp) = ours, theirs
        np.testing.assert_allclose(our_lp, np.asarray(their_lp), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert ours.dtype == np.int32 and ours.shape == (2, tp + max_new)
    if use_eos:
        first = int(np.argmax(ours[0, tp:] == eos))
        assert (ours[0, tp + first :] == eos).all()


@pytest.mark.parametrize(
    "top_k, top_p", [(5, None), (None, 0.7), (8, 0.5)], ids=["top_k", "top_p", "both"]
)
def test_filter_logits_matches(top_k, top_p) -> None:
    logits = np.random.default_rng(13).standard_normal((3, 50)).astype(np.float32) * 3
    ours = filter_logits(torch.from_numpy(logits), top_k=top_k, top_p=top_p).numpy()
    theirs = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
    kept = ~np.isinf(theirs)
    np.testing.assert_allclose(ours[kept], theirs[kept], atol=1e-5, rtol=0)


def test_sampling_is_seeded_and_respects_top_k(models) -> None:
    _, _, tm = models
    ids = seeded_ids(14, (1, 6), TINY["vocab_size"])

    def run(seed: int) -> np.ndarray:
        return generate(tm, ids, max_new_tokens=10, temperature=0.8, top_k=1,
                        generator=torch.Generator().manual_seed(seed))

    greedy = generate(tm, ids, max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(run(1), run(1))
    np.testing.assert_array_equal(run(2), greedy)  # top_k=1 leaves only the argmax


def test_contract_errors(models) -> None:
    _, _, tm = models
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, np.array([1, 2]), max_new_tokens=-1)
    with pytest.raises(ValueError, match="at least one token"):
        generate(tm, np.zeros((1, 0), np.int32), max_new_tokens=1)
    with pytest.raises(ValueError, match=r"prompt token ids must be in \[0, 61\)"):
        generate(tm, np.array([1, 99]), max_new_tokens=1)
    with pytest.raises(ValueError, match="block_size"):
        generate(tm, np.array([1, 2]), max_new_tokens=40, use_cache=True)
    out, lp = generate(tm, np.array([1, 2]), max_new_tokens=0, return_logprobs=True)
    assert out.tolist() == [[1, 2]] and lp.shape == (1, 0)
