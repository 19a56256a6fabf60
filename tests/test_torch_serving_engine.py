"""The port's paged decode engine and continuous-batching scheduler
against the JAX package and against the port's own generate().

A tiny GQA GPT (2 layers, d 64, 4 heads over 2 KV heads, block 64) in f32
with the same weights on both sides (interop/flax_params.py):

* the paged model's prefill and decode logits equal JAX's paged model for
  the same positions and block tables, rows at different depths
  (atol/rtol 2e-5, the band of tests/test_torch_gpt.py);
* ``_filter_rows`` keeps what JAX's keeps, per row;
* the port engine's greedy tokens equal the JAX engine's for a seeded
  mixed-length population;
* the engine's tokens, greedy and sampled, are bitwise those of the port's
  generate() for each request alone (JAX's TestBatchedParity);
* EOS retirement, queueing on pool exhaustion, a never-fitting request,
  abandonment, recovery after a failed step and the bucket budget (the
  counterparts of tests/test_serving_engine.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_gpt, port_gpt, seeded_ids, to_torch

from llmtrain_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from llmtrain_tpu.serving import PagedDecodeEngine as JaxEngine
from llmtrain_tpu.serving import ServeRequest as JaxRequest
from llmtrain_tpu.serving.engine import _filter_rows as jax_filter_rows
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    PagedDecodeEngine,
    ServeRequest,
    bucket_for,
)
from llmtrain_tpu_torch.serving.engine import _filter_rows
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry

ATOL = RTOL = 2e-5
VOCAB, BLOCK, BT = 61, 64, 8
ENGINE = dict(block_tokens=BT, max_batch_slots=4, prompt_buckets=[8, 16, 32, BLOCK],
              batch_buckets=[2, 4])


@pytest.fixture(scope="module")
def models():
    jm, params = jax_gpt(seed=21, block_size=BLOCK, n_kv_heads=2)
    return jm, params, port_gpt(jm, params)


def _drain(scheduler, requests, max_steps: int = 500) -> int:
    steps = 0
    while not all(r.done.is_set() for r in requests):
        scheduler.step()
        steps += 1
        assert steps < max_steps, "scheduler failed to finish the batch"
    return steps


def _reference(model, req: ServeRequest) -> list[int]:
    """What the port's generate() emits for this request alone, its
    generator seeded as `serve` seeds a request."""
    gen = torch.Generator()
    gen.manual_seed(req.seed)
    out = generate(model, req.prompt_ids[None, :], max_new_tokens=req.max_new_tokens,
                   temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                   eos_token_id=req.eos_token_id, generator=gen)
    ref = [int(t) for t in out[0, req.prompt_ids.shape[0]:]]
    if req.eos_token_id is not None and req.eos_token_id in ref:
        ref = ref[: ref.index(req.eos_token_id) + 1]
    return ref


def _tables(rows: list[list[int]]) -> np.ndarray:
    mb = BLOCK // BT
    return np.asarray([r + [0] * (mb - len(r)) for r in rows], np.int32)


def test_paged_logits_match_jax(models) -> None:
    """Prefill two rows of different lengths one at a time, then decode
    both together at their own depths (one and two tokens a call)."""
    jm, params, tm = models
    nb = 16
    jdm = jm.for_paged_decoding(num_blocks=nb, block_tokens=BT)
    shapes = jax.eval_shape(lambda: jdm.init(
        jax.random.key(0), jnp.zeros((1, 1), jnp.int32), positions=jnp.zeros((1,), jnp.int32),
        block_tables=jnp.zeros((1, BLOCK // BT), jnp.int32)))["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda variables, ids, pos, tab: jdm.apply(
        variables, ids, positions=pos, block_tables=tab, mutable=["cache"]))
    pdm = tm.for_paged_decoding(num_blocks=nb, block_tokens=BT)
    pool = pdm.init_pool()
    t0, t1 = [3, 7, 1], [9, 2, 11, 5]
    a, b = seeded_ids(22, (1, 20), VOCAB), seeded_ids(23, (1, 6), VOCAB)
    calls = [
        (a, [0], _tables([t0])),
        (b, [0], _tables([t1])),
        (np.asarray([[4], [8]], np.int32), [20, 6], _tables([t0, t1])),
        (np.asarray([[5, 6], [9, 10]], np.int32), [21, 7], _tables([t0, t1])),
    ]
    for ids, pos, tab in calls:
        j, mutated = step({"params": params, "cache": cache}, jnp.asarray(ids),
                          jnp.asarray(pos, jnp.int32), jnp.asarray(tab))
        cache = mutated["cache"]
        with torch.inference_mode():
            t = pdm(to_torch(ids).long(), to_torch(np.asarray(pos)).long(),
                    to_torch(tab).long(), pool)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_paged_decoding_refusals_match_jax(models) -> None:
    jm, _, tm = models
    for kw in (dict(num_blocks=1, block_tokens=8), dict(num_blocks=4, block_tokens=0)):
        with pytest.raises(ValueError) as theirs:
            jm.for_paged_decoding(**kw)
        with pytest.raises(ValueError) as ours:
            tm.for_paged_decoding(**kw)
        assert str(ours.value) == str(theirs.value)
    for attr, value in (("sliding_window", 16), ("kv_cache_dtype", "int8")):
        saved = getattr(tm, attr)
        setattr(tm, attr, value)
        try:
            with pytest.raises(ValueError) as ours:
                tm.for_paged_decoding(num_blocks=4, block_tokens=8)
        finally:
            setattr(tm, attr, saved)
        with pytest.raises(ValueError) as theirs:
            jm.clone(**{attr: value}).for_paged_decoding(num_blocks=4, block_tokens=8)
        assert str(ours.value) == str(theirs.value)


def test_filter_rows_matches_jax() -> None:
    rng = np.random.default_rng(24)
    logits = (rng.standard_normal((6, VOCAB)) * 3.0).astype(np.float32)
    top_ks = [0, 5, 1, 0, 12, VOCAB + 4]
    top_ps = [0.0, 0.0, 0.5, 0.9, 0.7, 1.0]
    theirs = np.asarray(jax_filter_rows(jnp.asarray(logits), jnp.asarray(top_ks, jnp.int32),
                                        jnp.asarray(top_ps, jnp.float32)))
    ours = _filter_rows(to_torch(logits), top_ks, top_ps).numpy()
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(theirs))
    np.testing.assert_array_equal(ours[~np.isneginf(ours)], theirs[~np.isneginf(theirs)])


def test_greedy_tokens_match_the_jax_engine(models) -> None:
    jm, params, tm = models
    rng = np.random.default_rng(25)
    spec = [(int(rng.integers(1, 30)), int(rng.integers(2, 12))) for _ in range(6)]
    prompts = [rng.integers(0, VOCAB, tp).astype(np.int32) for tp, _ in spec]
    jsched = JaxScheduler(JaxEngine(jm, params, **ENGINE))
    ours = ContinuousBatchingScheduler(PagedDecodeEngine(tm, **ENGINE))
    jreqs = [JaxRequest(prompt_ids=p, max_new_tokens=n) for p, (_, n) in zip(prompts, spec)]
    preqs = [ServeRequest(prompt_ids=p, max_new_tokens=n) for p, (_, n) in zip(prompts, spec)]
    for sched, reqs in ((jsched, jreqs), (ours, preqs)):
        for r in reqs:
            sched.submit(r)
        _drain(sched, reqs)
    assert ours.peak_occupancy >= 2
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]


@pytest.mark.parametrize(
    "serving",
    [dict(), dict(prefix_cache=True, prefill_chunk=8)],
    ids=["plain", "prefix-cache-chunked"],
)
def test_engine_is_bitwise_generate(models, serving) -> None:
    """Greedy and sampled rows with different knobs in flight together,
    and with shared prefixes (cache hits, a partial match copied on write)
    streamed in chunks: every request's tokens are generate()'s."""
    _, _, tm = models
    engine = PagedDecodeEngine(tm, **ENGINE, **serving)
    scheduler = ContinuousBatchingScheduler(engine, registry=MetricsRegistry())
    rng = np.random.default_rng(26)
    prefix = rng.integers(0, VOCAB, 21).astype(np.int32)
    knobs = [dict(temperature=0.0), dict(temperature=0.8, top_k=5),
             dict(temperature=1.3, top_p=0.9), dict(temperature=0.7, top_k=9, top_p=0.8)]
    requests = []
    for i in range(10):
        prompt = rng.integers(0, VOCAB, int(rng.integers(1, 20))).astype(np.int32)
        if i % 2:
            prompt = np.concatenate([prefix[: 13 + i], prompt]).astype(np.int32)
        requests.append(ServeRequest(prompt_ids=prompt, seed=100 + i,
                                     max_new_tokens=int(rng.integers(1, BLOCK - prompt.size)),
                                     **knobs[i % 4]))
    for req in requests:
        scheduler.submit(req)
    _drain(scheduler, requests)
    assert scheduler.peak_occupancy >= 2
    for req in requests:
        assert req.finish_reason == "length"
        assert req.tokens == _reference(tm, req), req.request_id
    stats = engine.pool.stats()
    assert stats["active_sequences"] == 0 and stats["allocated_blocks"] == 0
    assert engine.compile_stats()["within_budget"]
    if serving:
        assert stats["prefix_hit_queries"] > 0 and stats["cow_copies"] > 0


def test_eos_retires_without_draining_the_batch(models) -> None:
    _, _, tm = models
    scheduler = ContinuousBatchingScheduler(PagedDecodeEngine(tm, **ENGINE))
    probe = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=6)
    eos = _reference(tm, probe)[2]
    short = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=6,
                         eos_token_id=eos)
    long = ServeRequest(prompt_ids=np.asarray([4, 5, 6], np.int32), max_new_tokens=12)
    scheduler.submit(short)
    scheduler.submit(long)
    steps = 0
    while not short.done.is_set():
        scheduler.step()
        steps += 1
        assert steps < 50
    assert short.finish_reason == "eos" and short.tokens[-1] == eos
    assert not long.done.is_set() and len(scheduler._active) == 1
    _drain(scheduler, [long])
    assert short.tokens == _reference(tm, short)
    assert long.tokens == _reference(tm, long)


def test_pool_exhaustion_queues_and_never_fitting_fails(models) -> None:
    _, _, tm = models
    # Pool for ONE worst-case sequence of 16 positions: 1 null + 2 blocks.
    engine = PagedDecodeEngine(tm, **{**ENGINE, "num_blocks": 3, "max_batch_slots": 2,
                                      "batch_buckets": [2]})
    assert "block_size" in engine.validate_request(4, BLOCK)
    assert "pool" in engine.validate_request(4, 20)
    assert engine.validate_request(4, 12) is None
    scheduler = ContinuousBatchingScheduler(engine)
    a = ServeRequest(prompt_ids=np.asarray([1, 2, 3, 4], np.int32), max_new_tokens=12)
    b = ServeRequest(prompt_ids=np.asarray([5, 6], np.int32), max_new_tokens=4)
    never = ServeRequest(prompt_ids=np.asarray([1, 2, 3, 4], np.int32), max_new_tokens=20)
    behind = ServeRequest(prompt_ids=np.asarray([5, 6], np.int32), max_new_tokens=3)
    for r in (a, b):
        scheduler.submit(r)
    scheduler.step()
    assert len(scheduler._active) == 1 and scheduler.stats()["queue_depth"] == 1
    for r in (never, behind):
        scheduler.submit(r)
    _drain(scheduler, [a, b, never, behind])
    assert (a.finish_reason, b.finish_reason, behind.finish_reason) == ("length",) * 3
    assert never.finish_reason == "error" and "pool" in never.error
    assert b.tokens == _reference(tm, b)


def test_abandonment_and_recovery_after_a_failed_step(models, monkeypatch) -> None:
    _, _, tm = models
    engine = PagedDecodeEngine(tm, **ENGINE)
    scheduler = ContinuousBatchingScheduler(engine)
    flying = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=8)
    scheduler.submit(flying)
    scheduler.step()
    tokens_at_shed = len(flying.tokens)
    queued = ServeRequest(prompt_ids=np.asarray([4, 5], np.int32), max_new_tokens=4)
    survivor = ServeRequest(prompt_ids=np.asarray([6, 7], np.int32), max_new_tokens=4)
    flying.abandon()
    queued.abandon()
    scheduler.submit(queued)
    scheduler.submit(survivor)
    _drain(scheduler, [flying, queued, survivor])
    assert (flying.finish_reason, queued.finish_reason) == ("abandoned", "abandoned")
    assert queued.tokens == [] and len(flying.tokens) == tokens_at_shed
    assert survivor.tokens == _reference(tm, survivor)
    assert engine.pool.stats()["allocated_blocks"] == 0

    victim = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=6)
    scheduler.submit(victim)
    scheduler.step()
    assert len(scheduler._active) == 1

    def exploding(*args, **kwargs):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(type(engine.decode_model), "__call__", exploding)
    scheduler.step()  # must not raise
    monkeypatch.undo()
    assert victim.finish_reason == "error" and "injected device failure" in victim.error
    assert engine.cache_epoch == 1
    assert all(not t.any() for t in (*engine._cache.key, *engine._cache.value))
    after = ServeRequest(prompt_ids=np.asarray([4, 5, 6], np.int32), max_new_tokens=4, seed=1)
    scheduler.submit(after)
    _drain(scheduler, [after])
    assert after.tokens == _reference(tm, after)
    assert engine.pool.stats()["allocated_blocks"] == 0


def test_shapes_stay_bucketed(models) -> None:
    """Repeating a bucket shape does not grow the shape count, and every
    shape used is a bucket (JAX's compile-budget test)."""
    _, _, tm = models
    engine = PagedDecodeEngine(tm, **ENGINE)
    scheduler = ContinuousBatchingScheduler(engine)

    def burst(seed: int) -> None:
        reqs = [ServeRequest(prompt_ids=np.asarray([seed, 2, 3], np.int32), max_new_tokens=3),
                ServeRequest(prompt_ids=np.asarray([seed, 5], np.int32), max_new_tokens=3)]
        for r in reqs:
            scheduler.submit(r)
        _drain(scheduler, reqs)

    burst(1)
    first = engine.compile_stats()
    burst(2)
    second = engine.compile_stats()
    assert second == first and second["within_budget"]
    assert set(second["prefill_shapes_used"]) <= set(engine.prompt_buckets)
    assert set(second["decode_shapes_used"]) <= set(engine.batch_buckets)
    assert bucket_for(3, [2, 4]) == 4
    with pytest.raises(ValueError, match="exceeds"):
        bucket_for(5, [2, 4])


def test_hot_swap_pins_in_flight_rows(models) -> None:
    """A swap mid-flight: the row admitted before it finishes on the old
    weights (generate() with them), the row admitted after decodes on the
    new ones, and the old model is released when its last row retires."""
    jm, params, tm = models
    other = port_gpt(jm, jax.tree.map(lambda x: x * 1.5, params))
    engine = PagedDecodeEngine(tm, **ENGINE)
    scheduler = ContinuousBatchingScheduler(engine)
    before = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=10)
    scheduler.submit(before)
    scheduler.step()
    scheduler.hot_swap(other, step=7)
    after = ServeRequest(prompt_ids=np.asarray([1, 2, 3], np.int32), max_new_tokens=10)
    scheduler.submit(after)
    scheduler.step()
    assert scheduler.stats()["params"]["live_epochs"] == [0, 1]
    _drain(scheduler, [before, after])
    assert before.tokens == _reference(tm, before) and before.params_step is None
    assert after.tokens == _reference(other, after) and after.params_step == 7
    assert scheduler.stats()["params"]["live_epochs"] == [1]
