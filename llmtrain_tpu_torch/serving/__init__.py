"""Inference serving (port of ``llmtrain_tpu/serving/``): simple mode and
continuous batching.

* :mod:`~.http` — the stdlib HTTP surface (healthz / metrics / generate /
  reload), lock-protected cross-request stats;
* :mod:`~.paged_kv` — the paged KV-cache block pool: free-list allocator,
  admission-time budget reservation, per-sequence block tables, the
  shared-prefix cache;
* :mod:`~.engine` — bucketed prefill/decode steps over the pool, per-row
  generate()-exact sampling, the batched speculative ``verify``,
  bounded-shape accounting;
* :mod:`~.scheduler` — continuous (in-flight) batching: admission queue,
  per-step join/evict, hot swap, speculative decoding as a policy
  (batched draft-and-verify, batch 1 for sampled requests), ``serve/*``
  metrics;
* :mod:`~.loadgen` — seeded open-loop arrival harness emitting the
  p50/p95/p99 TTFT + per-token SLO block;
* :mod:`~.overload` — SLO-aware overload control: bounded deadline-aware
  admission, priority classes with token buckets, load shedding, brownout
  with hysteresis, the retry budget;
* :mod:`~.router` — the replica router: prefix-affinity and load-aware
  placement over in-process or HTTP replicas, eviction, revival and
  failover, rolling reloads, the canary split.
"""

from .engine import PagedDecodeEngine, bucket_for
from .http import ServerState, ServerStats, make_server
from .loadgen import build_requests, percentiles, run_loadgen
from .overload import (
    REJECT_REASONS,
    Brownout,
    ClientRateGate,
    EwmaWaitEstimator,
    OverloadController,
    RetryBudget,
    TokenBucket,
    WeightedClassQueue,
    rejected_counter,
)
from .paged_kv import NULL_BLOCK, BlockTable, PagedKVPool, PrefixMatch, chain_hashes
from .router import (
    HTTPReplica,
    InProcessReplica,
    ReplicaBackpressure,
    ReplicaRouter,
    resolve_backends,
)
from .scheduler import ContinuousBatchingScheduler, ServeRequest

__all__ = [
    "NULL_BLOCK",
    "REJECT_REASONS",
    "BlockTable",
    "Brownout",
    "ClientRateGate",
    "ContinuousBatchingScheduler",
    "EwmaWaitEstimator",
    "HTTPReplica",
    "InProcessReplica",
    "OverloadController",
    "ReplicaBackpressure",
    "RetryBudget",
    "TokenBucket",
    "WeightedClassQueue",
    "PagedDecodeEngine",
    "PagedKVPool",
    "PrefixMatch",
    "ReplicaRouter",
    "ServeRequest",
    "ServerState",
    "ServerStats",
    "bucket_for",
    "build_requests",
    "chain_hashes",
    "make_server",
    "percentiles",
    "rejected_counter",
    "resolve_backends",
    "run_loadgen",
]
