"""Open-loop load generator + SLO aggregation for the serving stack (port
of ``llmtrain_tpu/serving/loadgen.py``).

Drives the continuous-batching scheduler with a SEEDED open-loop arrival
process — requests arrive on a Poisson clock that does NOT wait for
completions, the arrival model under which tail latency means anything (a
closed loop self-throttles and hides queueing collapse) — and aggregates
the scheduler's server-side measurements into the SLO numbers operators
page on:

* **TTFT** (submit → first token) p50/p95/p99,
* **per-token latency** (inter-token gaps) p50/p95/p99,
* tokens/s and requests/s over the run,
* batch-occupancy and KV-pool peaks, and the bounded-shape accounting.

The result feeds the ``serve-bench`` CLI's stdout summary and the
``llmtrain_serve_*`` gauges of the MetricsRegistry. The request population
comes from one numpy Generator, so a seed gives the same population as the
JAX package's; everything is deterministic per (seed, rate, request count)
except wall-clock timing itself.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from ..telemetry.stats import percentiles as _stats_percentiles
from .scheduler import ContinuousBatchingScheduler, ServeRequest


def percentiles(samples: list[float]) -> dict[str, float | None]:
    """p50/p95/p99/mean/max by nearest-rank on the sorted samples —
    thin back-compat wrapper over the shared ``telemetry.stats`` helper
    (same math as /metrics gauges and ``llmtrain trace summary``), keeping
    this module's explicit-None shape for empty sample sets."""
    if not samples:
        return {"p50": None, "p95": None, "p99": None, "mean": None, "max": None}
    return _stats_percentiles([float(v) for v in samples])


def build_requests(
    *,
    num_requests: int,
    seed: int,
    vocab_size: int,
    prompt_tokens_min: int,
    prompt_tokens_max: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    shared_prefix_tokens: int = 0,
    shared_prefix_count: int = 1,
    long_fraction: float = 0.0,
    long_prompt_tokens: int = 0,
    deadline_ms: float | None = None,
    batch_fraction: float = 0.0,
) -> list[ServeRequest]:
    """Seeded request population: prompt lengths/ids and per-request rng
    seeds all derive from one numpy Generator, so a run is replayable —
    the property the bitwise parity check against ``generate()`` needs.

    Two mix knobs shape the population for the fleet features:

    * ``shared_prefix_tokens`` > 0 prepends one of
      ``shared_prefix_count`` fixed "system prompts" (seeded, chosen per
      request) — the workload where shared-prefix KV reuse and the
      router's prefix-affinity placement pay off;
    * ``long_fraction`` > 0 makes that fraction of requests use
      ``long_prompt_tokens``-token prompts (the rest stay in the
      min..max band) — the bimodal long/short mix chunked prefill
      exists for.

    Overload knobs: ``deadline_ms`` stamps every request with a latency
    budget (the admission controller's rejection signal), and
    ``batch_fraction`` > 0 marks that seeded fraction of requests
    ``priority="batch"`` — the mixed-class workload the weighted dequeue
    exists for. Both draw no extra rng when unused, so pre-existing
    seeded populations replay identically.
    """
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(0, vocab_size, size=shared_prefix_tokens, dtype=np.int64)
        .astype(np.int32)
        for _ in range(shared_prefix_count if shared_prefix_tokens > 0 else 0)
    ]
    reqs: list[ServeRequest] = []
    for i in range(num_requests):
        if long_fraction > 0.0 and rng.random() < long_fraction:
            tp = int(long_prompt_tokens)
        else:
            tp = int(rng.integers(prompt_tokens_min, prompt_tokens_max + 1))
        prompt = rng.integers(0, vocab_size, size=tp, dtype=np.int64).astype(
            np.int32
        )
        if prefixes:
            prefix = prefixes[int(rng.integers(0, len(prefixes)))]
            prompt = np.concatenate([prefix, prompt]).astype(np.int32)
        priority = "interactive"
        if batch_fraction > 0.0 and rng.random() < batch_fraction:
            priority = "batch"
        reqs.append(
            ServeRequest(
                prompt_ids=prompt,
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                seed=int(rng.integers(0, 2**31 - 1)),
                eos_token_id=eos_token_id,
                deadline_ms=deadline_ms,
                priority=priority,
                rid=f"lg-{seed}-{i}",
            )
        )
    return reqs


def run_loadgen(
    scheduler: ContinuousBatchingScheduler,
    requests: list[ServeRequest],
    *,
    rate_rps: float,
    seed: int,
    timeout_sec: float = 300.0,
    arrival: str = "poisson",
    burst_factor: float = 10.0,
) -> dict[str, Any]:
    """Submit ``requests`` on a seeded open-loop arrival clock and block
    until every one completes (or ``timeout_sec`` lapses); returns the
    ``serving`` report block. The scheduler must already be running
    (``scheduler.start()``).

    ``arrival="poisson"`` is the steady open-loop process;
    ``arrival="burst"`` keeps the head and tail 20% of requests at
    ``rate_rps`` but drives the middle 60% at ``rate_rps *
    burst_factor`` — the seeded overload drill (calm → 10× burst → calm)
    that exercises admission control, shedding, and brownout hysteresis
    entry AND exit."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if arrival not in ("poisson", "burst"):
        raise ValueError(f"unknown arrival process {arrival!r}")
    if burst_factor <= 0:
        raise ValueError(f"burst_factor must be > 0, got {burst_factor}")
    arrival_rng = np.random.default_rng(seed ^ 0x5EED)
    if arrival == "burst":
        n = len(requests)
        rates = np.full(n, rate_rps)
        lo, hi = int(n * 0.2), int(n * 0.8)
        rates[lo:hi] = rate_rps * burst_factor
        # Unit-rate exponential gaps scaled per request: the SAME seeded
        # gap stream as the poisson process, squeezed where the burst is.
        offsets = np.cumsum(arrival_rng.exponential(1.0, n) / rates)
    else:
        offsets = np.cumsum(
            arrival_rng.exponential(1.0 / rate_rps, len(requests))
        )

    t0 = time.monotonic()
    for req, offset in zip(requests, offsets):
        delay = (t0 + offset) - time.monotonic()
        if delay > 0:
            # Open loop: the sleep tracks the ARRIVAL clock, never the
            # completion of earlier requests.
            time.sleep(delay)
        scheduler.submit(req)

    deadline = time.monotonic() + timeout_sec
    for req in requests:
        if not req.done.wait(timeout=max(0.0, deadline - time.monotonic())):
            req.abandon()  # shed: don't keep decoding for a lapsed run
    wall_sec = time.monotonic() - t0

    # Classify from FINAL state, after the scheduler has either retired
    # or shed every abandoned request — a request finishing in the window
    # between its lapsed wait() and the next shed check is a completion,
    # not a timeout (it must not be double-counted as both and fail the
    # bench run).
    for req in requests:
        req.done.wait(timeout=30.0)
    completed = [r for r in requests if r.finish_reason in ("eos", "length")]
    failed = [r for r in requests if r.finish_reason == "error"]
    # Overload-control outcomes: rejected at submit (fast 429) vs shed
    # from the queue past-deadline. Neither is a failure — they are the
    # system degrading AS DESIGNED; serve-bench bounds their fraction
    # separately (--max-rejected-frac).
    rejected = [r for r in requests if r.finish_reason == "rejected"]
    shed = [r for r in requests if r.finish_reason == "shed"]
    incomplete = (
        len(requests)
        - len(completed)
        - len(failed)
        - len(rejected)
        - len(shed)
    )
    ttft = [r.ttft_ms for r in completed if r.ttft_ms is not None]
    per_token: list[float] = []
    for r in completed:
        for a, b in zip(r.token_times, r.token_times[1:]):
            per_token.append((b - a) * 1e3)
    new_tokens = sum(len(r.tokens) for r in completed)

    stats = scheduler.stats()
    arrival_block: dict[str, Any] = {
        "process": f"{arrival}-open-loop",
        "rate_rps": rate_rps,
        "seed": seed,
    }
    if arrival == "burst":
        arrival_block["burst_factor"] = burst_factor
    block: dict[str, Any] = {
        "arrival": arrival_block,
        "requests": {
            "submitted": len(requests),
            "completed": len(completed),
            "failed": len(failed),
            "rejected": len(rejected),
            "shed": len(shed),
            "timed_out": incomplete,
        },
        "slo": {
            "ttft_ms": percentiles(ttft),
            "per_token_ms": percentiles(per_token),
        },
        "throughput": {
            "wall_sec": round(wall_sec, 3),
            "new_tokens": new_tokens,
            "tokens_per_sec": round(new_tokens / wall_sec, 3) if wall_sec else None,
            "requests_per_sec": (
                round(len(completed) / wall_sec, 3) if wall_sec else None
            ),
        },
        "occupancy": {
            "peak": stats["peak_batch_occupancy"],
            "mean": stats["mean_batch_occupancy"],
            "max_batch_slots": stats["max_batch_slots"],
        },
        "policy": stats["policy"],
    }
    if "kv_pool" in stats:
        block["kv_pool"] = stats["kv_pool"]
        pool = stats["kv_pool"]
        if "prefix_hit_rate" in pool:
            # Shared-prefix reuse: blocks bound from cache instead of
            # re-prefilled.
            block["prefix_cache"] = {
                "hits": pool["prefix_hits"],
                "queries": pool["prefix_queries"],
                "hit_rate": pool["prefix_hit_rate"],
                "tokens_reused": pool["prefix_tokens_reused"],
                "evictions": pool["prefix_evictions"],
                "cow_copies": pool["cow_copies"],
            }
    if "compile" in stats:
        block["compile"] = stats["compile"]
    if "params" in stats:
        block["params"] = stats["params"]
    if rejected or shed or "overload" in stats:
        # Overload-control outcomes, gateable like parity: the reason
        # taxonomy, how FAST the rejections were (a slow rejection is a
        # failed fast-fail), and the controller's own counters.
        by_reason: dict[str, int] = {}
        for r in rejected + shed:
            key = r.reject_reason or "unknown"
            by_reason[key] = by_reason.get(key, 0) + 1
        rejection_latency = [
            (r.finished_t - r.submitted_t) * 1e3
            for r in rejected + shed
            if r.finished_t > 0 and r.submitted_t > 0
        ]
        overload_block: dict[str, Any] = {
            "rejected": len(rejected),
            "shed": len(shed),
            "rejected_by_reason": by_reason,
            "rejection_latency_ms": percentiles(rejection_latency),
        }
        controller = stats.get("overload")
        if controller is not None:
            overload_block["controller"] = controller
        block["overload"] = overload_block

    registry = scheduler.registry
    if registry is not None:
        for name, stat in (("ttft_ms", ttft), ("per_token_ms", per_token)):
            pct = percentiles(stat)
            for q in ("p50", "p95", "p99"):
                if pct[q] is not None:
                    registry.publish({f"serve/{name}_{q}": pct[q]})
        if block["throughput"]["tokens_per_sec"] is not None:
            registry.publish(
                {"serve/tokens_per_sec": block["throughput"]["tokens_per_sec"]}
            )
    return block


__all__ = ["build_requests", "percentiles", "run_loadgen"]
