"""The port's decode caches against JAX's ``for_decoding`` caches.

A tiny GPT (2 layers, d 64, 4 heads, f32) with the same weights on both
sides (interop/flax_params.py), fed a prefill and then single-token steps:

* the rolling sliding-window cache (sliding_window < cache_len), dense
  and GQA, with and without ``ring_slack``: logits at every call within
  atol/rtol 2e-5 of JAX's, the ring's positions equal to JAX's
  ``cached_pos1``; a prefill longer than the ring keeps only its last
  position exact (JAX's documented rolling-prefill caveat);
* the int8 cache, linear and rolling: codes equal to JAX's, scales within
  the f32 rounding of the K/V they come from (rtol 1e-6), logits within
  2e-5;
* cursor rollback (``KVCache.set_cursor``, JAX's ``_set_cursor``): stale
  slots past the cursor leave the logits where a clean run puts them;
* the port's own invariant: a query's logits do not depend on the ring's
  slack or on how many tokens its call carried (bit for bit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_gpt, port_gpt, seeded_ids, to_torch

from llmtrain_tpu.speculative import _set_cursor

ATOL = RTOL = 2e-5
VOCAB = 61


def _jax_decoder(jm, batch: int, cache_len: int, ring_slack: int = 0):
    dm = jm.for_decoding(cache_len=cache_len, ring_slack=ring_slack)
    shapes = jax.eval_shape(
        lambda: dm.init(jax.random.key(0), jnp.zeros((batch, 1), jnp.int32))
    )["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda variables, tokens: dm.apply(variables, tokens, mutable=["cache"]))
    return step, cache


def _run_both(jm, params, tm, ids, chunks, *, cache_len, ring_slack=0):
    """Feed ``ids`` in chunks of the given sizes to both decoders; yields
    (JAX logits, port logits, JAX cache, port cache) after each call."""
    step, cache = _jax_decoder(jm, ids.shape[0], cache_len, ring_slack)
    decoder = tm.for_decoding(cache_len=cache_len, ring_slack=ring_slack)
    kv = decoder.init_cache(ids.shape[0])
    start = 0
    for n in chunks:
        chunk = ids[:, start:start + n]
        start += n
        j, mutated = step({"params": params, "cache": cache}, jnp.asarray(chunk))
        cache = mutated["cache"]
        with torch.no_grad():
            t = decoder(to_torch(chunk).long(), kv)
        yield np.asarray(j), t.numpy(), cache, kv


@pytest.mark.parametrize("n_kv_heads, ring_slack", [(0, 0), (2, 0), (2, 3)],
                         ids=["dense", "gqa", "gqa-slack3"])
def test_rolling_cache_matches_jax(n_kv_heads: int, ring_slack: int) -> None:
    """Window 6 in a 24-position cache: a 5-token prefill, then 15 steps
    that wrap the ring twice."""
    jm, params = jax_gpt(seed=31, n_kv_heads=n_kv_heads, sliding_window=6)
    tm = port_gpt(jm, params)
    ids = seeded_ids(32, (2, 20), VOCAB)
    calls = 0
    for j, t, cache, kv in _run_both(jm, params, tm, ids, [5] + [1] * 15, cache_len=24,
                                     ring_slack=ring_slack):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
        jpos = np.asarray(cache["block_0"]["attn"]["cached_pos1"])
        assert kv.layers[0].pos1.shape == (6 + ring_slack,)
        np.testing.assert_array_equal(kv.layers[0].pos1.numpy(), jpos)
        calls += 1
    assert calls == 16


def test_rolling_prefill_longer_than_the_ring() -> None:
    """A 14-token prefill into a 6-slot ring writes only its last 6 tokens;
    the last position's window is exactly that set, so its logits match
    JAX's, and so do the steps after it."""
    jm, params = jax_gpt(seed=33, sliding_window=6)
    tm = port_gpt(jm, params)
    ids = seeded_ids(34, (1, 18), VOCAB)
    for i, (j, t, _, _) in enumerate(_run_both(jm, params, tm, ids, [14, 1, 1, 1, 1],
                                               cache_len=24)):
        if i == 0:
            j, t = j[:, -1:], t[:, -1:]
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 6], ids=["linear", "rolling"])
def test_int8_cache_matches_jax(window: int) -> None:
    jm, params = jax_gpt(seed=35, n_kv_heads=2, sliding_window=window, kv_cache_dtype="int8")
    tm = port_gpt(jm, params)
    tm.kv_cache_dtype = "int8"
    ids = seeded_ids(36, (2, 16), VOCAB)
    for j, t, cache, kv in _run_both(jm, params, tm, ids, [7] + [1] * 9, cache_len=16):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
        for i, layer in enumerate(kv.layers):
            jc = cache[f"block_{i}"]["attn"]
            assert layer.key.dtype == torch.int8 and layer.value.dtype == torch.int8
            np.testing.assert_array_equal(layer.key.numpy(), np.asarray(jc["cached_key"]))
            np.testing.assert_array_equal(layer.value.numpy(), np.asarray(jc["cached_value"]))
            # The scales are amax/127 of K/V rows that carry the products'
            # f32 rounding: equal to that rounding.
            np.testing.assert_allclose(layer.key_scale.numpy(), np.asarray(jc["key_scale"]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(layer.value_scale.numpy(), np.asarray(jc["value_scale"]),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("window", [0, 6], ids=["linear", "rolling"])
def test_cursor_rollback_matches_jax(window: int) -> None:
    """Write 3 garbage tokens past position 9, roll the cursor back to 9,
    then feed the real tokens: every logit equals JAX's after the same
    rollback, and the clean run's."""
    jm, params = jax_gpt(seed=37, sliding_window=window)
    tm = port_gpt(jm, params)
    ids = seeded_ids(38, (1, 14), VOCAB)
    junk = seeded_ids(39, (1, 3), VOCAB)
    step, cache = _jax_decoder(jm, 1, 24, ring_slack=4)
    decoder = tm.for_decoding(cache_len=24, ring_slack=4)
    kv = decoder.init_cache(1)
    clean = decoder.model.for_decoding(cache_len=24, ring_slack=4)
    kv_clean = clean.init_cache(1)
    with torch.no_grad():
        for chunk in (ids[:, :9], junk):
            _, mutated = step({"params": params, "cache": cache}, jnp.asarray(chunk))
            cache = mutated["cache"]
            decoder(to_torch(chunk).long(), kv)
        clean(to_torch(ids[:, :9]).long(), kv_clean)
        cache = _set_cursor(cache, 9)
        kv.set_cursor(9)
        for i in range(9, 14):
            chunk = ids[:, i:i + 1]
            j, mutated = step({"params": params, "cache": cache}, jnp.asarray(chunk))
            cache = mutated["cache"]
            t = decoder(to_torch(chunk).long(), kv)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
            assert torch.equal(t, clean(to_torch(chunk).long(), kv_clean))


def test_window_read_does_not_depend_on_slack_or_call() -> None:
    """The rolling read is each query's own window in position order: the
    same tokens fed one at a time into a 6-slot ring, and three at a time
    into a 10-slot ring, give the same logits bit for bit."""
    jm, params = jax_gpt(seed=40, n_kv_heads=2, sliding_window=6)
    tm = port_gpt(jm, params)
    ids = to_torch(seeded_ids(41, (1, 19), VOCAB)).long()
    with torch.no_grad():
        one = tm.for_decoding(cache_len=32)
        kv1 = one.init_cache(1)
        first = [one(ids[:, :4], kv1)[:, -1]]
        first += [one(ids[:, i:i + 1], kv1)[:, 0] for i in range(4, 19)]
        wide = tm.for_decoding(cache_len=32, ring_slack=4)
        kv3 = wide.init_cache(1)
        second = [wide(ids[:, :4], kv3)[:, -1]]
        for i in range(4, 19, 3):
            second += list(wide(ids[:, i:i + 3], kv3).unbind(1))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_decoder_refusals() -> None:
    jm, params = jax_gpt(seed=42)
    tm = port_gpt(jm, params)
    tm.kv_cache_dtype = "fp4"
    with pytest.raises(ValueError, match="kv_cache_dtype 'fp4' unknown"):
        tm.for_decoding()
    tm.kv_cache_dtype = "model"
    with pytest.raises(ValueError, match="ring_slack must be >= 0"):
        tm.for_decoding(ring_slack=-1)
