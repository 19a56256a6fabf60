"""The port's replica router against the JAX package's, and the fleet tier
end to end on the CPU.

* JAX's router scenarios (placement, affinity, eviction, failover, revival
  backoff, the canary split, epoch divergence, reload_replica; the
  scenarios of tests/test_router.py over its FakeReplica) run against both
  routers: the same replica indices, results and ``stats()``;
* a 2-replica in-process fleet with shared-prefix requests, chunked
  prefill and a ``rolling_reload`` to a second weight set mid-drill: no
  request fails, every request equals the port's ``generate()`` bit for bit
  on the weights it was admitted under, and greedy tokens equal JAX's
  ``generate()``;
* a reload never mutates the module an older epoch still reads;
* a trace drill: two HTTP replicas and a dead backend behind the router,
  the cross-process span tree and critical path of JAX's
  tests/test_trace_e2e.py rebuilt from the timelines, exemplars on
  ``/metrics``;
* ``trace --json`` of the port on a run dir of JAX's serve-bench, and the
  JAX CLI on the port's, with equal JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch_port_helpers import jax_gpt, port_env, port_gpt, random_params, run_cli

import llmtrain_tpu.serving.router as jax_router_mod
from llmtrain_tpu import cli as jax_cli
from llmtrain_tpu.config import load_and_validate_config as jax_load
from llmtrain_tpu.generation import generate as jax_generate
from llmtrain_tpu.registry import get_model_adapter, initialize_registries
from llmtrain_tpu.serving.scheduler import ServeRequest as JaxServeRequest
from llmtrain_tpu.telemetry.prometheus import render_prometheus as jax_render
from llmtrain_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from llmtrain_tpu.training.checkpoint import CheckpointManager
from llmtrain_tpu_torch import cli
from llmtrain_tpu_torch.generation import generate
from llmtrain_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    HTTPReplica,
    InProcessReplica,
    PagedDecodeEngine,
    ReplicaRouter,
    ServerState,
    ServeRequest,
    build_requests,
    make_server,
    run_loadgen,
)
from llmtrain_tpu_torch.serving import router as port_router_mod
from llmtrain_tpu_torch.telemetry.prometheus import render_prometheus as port_render
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry as PortRegistry
from llmtrain_tpu_torch.telemetry.timeline import EventTimeline
from llmtrain_tpu_torch.telemetry.trace_collect import (
    collect_traces,
    critical_path,
    discover_sources,
    format_tree,
)
from llmtrain_tpu_torch.telemetry.tracing import TailSampler, Tracer

ROUTERS = {
    "port": SimpleNamespace(mod=port_router_mod, Request=ServeRequest, Registry=PortRegistry,
                            render=port_render),
    "jax": SimpleNamespace(mod=jax_router_mod, Request=JaxServeRequest,
                           Registry=lambda: JaxRegistry(None), render=jax_render),
}


class FakeReplica:
    """JAX's test double: records placements, fails on demand."""

    engine = None

    def __init__(self, name: str, load: float = 0.0, fail: bool = False, step=None, epoch=None):
        self.name, self._load, self.fail = name, load, fail
        self.served: list = []
        self.reloads: list = []
        self.probe_ok = True
        self.reload_error: str | None = None
        self.step, self.epoch = step, epoch

    def load(self) -> float:
        return self._load

    def submit(self, req):
        if self.fail:
            raise RuntimeError(f"{self.name} down")
        self.served.append(req)
        req.tokens = [1]
        req.finish_reason = "length"
        req.done.set()
        return req

    def stats(self) -> dict:
        out = {
            "policy": "paged", "peak_batch_occupancy": 1, "mean_batch_occupancy": 0.5,
            "max_batch_slots": 4, "queue_depth": 0, "active_sequences": 0,
            "requests_finished": len(self.served), "tokens_generated": len(self.served),
            "kv_pool": {"prefix_hits": 4, "prefix_queries": 2, "prefix_hit_queries": 1,
                        "prefix_tokens_reused": 16, "utilization": 0.0},
        }
        if self.step is not None or self.epoch is not None:
            out["params"] = {"step": self.step, "epoch": self.epoch}
        return out

    def healthcheck(self) -> bool:
        return self.probe_ok

    def reload(self, *, params=None, step=None, checkpoint=None) -> dict:
        if self.reload_error:
            raise RuntimeError(self.reload_error)
        self.reloads.append(step)
        return {"replica": self.name, "step": step}

    def close(self) -> None:
        pass


def _try(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 — the error is part of the answer
        return (type(exc).__name__, str(exc))


def _ids(base: int, n: int = 8) -> np.ndarray:
    return np.arange(base, base + n, dtype=np.int32)


def _placement(ns, fakes, **kw):
    router = ns.mod.ReplicaRouter(fakes, block_tokens=4, **kw)

    def req(prompt):
        return ns.Request(prompt_ids=np.asarray(prompt, np.int32), max_new_tokens=4)

    def served_by(r):
        return [f.name for f in fakes if any(x is r for x in f.served)]

    return router, req, served_by


def _scenario(name: str, ns) -> list:
    """One of JAX's router scenarios; returns what it observed."""
    F = FakeReplica
    out: list = []
    if name == "requires-a-replica":
        out.append(_try(lambda: ns.mod.ReplicaRouter([])))
    elif name == "least-loaded":
        router, _, _ = _placement(ns, [F("a", 3.0), F("b", 1.0)])
        out.append(router.select(_ids(0)))
    elif name == "affinity-until-load-gap":
        a, b = F("a"), F("b")
        router, _, _ = _placement(ns, [a, b], affinity_weight=4.0)
        first = router.select(_ids(0))
        [a, b][first]._load = 5.0
        out.append((first, router.select(_ids(0))))
        [a, b][first]._load = 9.0
        out += [router.select(_ids(0)), router.stats()]
    elif name == "distinct-prefixes":
        a, b = F("a"), F("b")
        router, req, served_by = _placement(ns, [a, b])
        r = router.submit(req(list(range(8))))
        first = router.select(_ids(0))
        [a, b][first]._load = 1.0
        out += [served_by(r), first, router.select(_ids(100)), router.requests_routed]
    elif name == "affinity-lru-cap":
        router, _, _ = _placement(ns, [F("a")], max_affinity_entries=4)
        out += [router.select(_ids(base)) for base in range(0, 80, 8)]
        out.append(router.stats())
    elif name == "failover-then-eviction":
        a, b = F("a", fail=True), F("b", 10.0)
        router, req, served_by = _placement(ns, [a, b], fail_threshold=2, revive_sec=60.0)
        for _ in range(3):
            r = router.submit(req(list(range(4))))
            out += [served_by(r), r.finish_reason, router.failovers]
        out.append(router.stats())
    elif name == "all-down":
        router, req, _ = _placement(ns, [F("a", fail=True)], fail_threshold=1, revive_sec=60.0)
        out.append(_try(lambda: router.submit(req(list(range(4))))))
    elif name == "revives-on-probe":
        a, b = F("a", fail=True), F("b", 5.0)
        router, req, served_by = _placement(ns, [a, b], fail_threshold=1, revive_sec=0.05)
        router.submit(req(list(range(4))))
        out.append(router.stats()["router"]["replicas_healthy"])
        a.fail = False
        time.sleep(0.06)
        r = router.submit(req(list(range(200, 204))))
        out += [router.stats(), served_by(r)]
    elif name == "rolling-reload":
        a, b, c = F("a", fail=True), F("b"), F("c")
        router, req, _ = _placement(ns, [a, b, c], fail_threshold=1, revive_sec=60.0)
        router.submit(req(list(range(4))))
        c.reload_error = "disk full"
        out += [router.rolling_reload(params=object(), step=42), b.reloads, c.reloads]
    elif name == "stats-and-fleet-hit-rate":
        router, req, _ = _placement(ns, [F("a"), F("b")])
        router.submit(req(list(range(8))))
        out.append(router.stats())
    elif name == "prometheus-gauges":
        registry = ns.Registry()
        router, req, _ = _placement(ns, [F("a"), F("b")], registry=registry)
        router.submit(req(list(range(8))))
        router.stats()
        out.append(ns.render(dict(registry.latest()), registry.counters(), {}))
    elif name == "resolve-literal-host":
        out += [ns.mod.resolve_backends("127.0.0.1:9123"), ns.mod.resolve_backends("127.0.0.1")]
    elif name == "revival-backoff":
        a, b = F("a", fail=True), F("b")
        router, req, _ = _placement(ns, [a, b], fail_threshold=1, revive_sec=10.0)
        router.submit(req(list(range(4))))
        s = router._states[0]
        a.probe_ok = False
        for back, ok in ((0.0, False), (10.0, False), (10.0, False), (20.0, False),
                         (40.0, True)):
            if ok:
                a.probe_ok, a.fail = True, False
            if back:
                s.evicted_at = time.monotonic() - back
            router._healthy_indices()
            out.append((s.revive_probes, s.revive_backoff, s.healthy))
        out.append(router.stats())
    elif name == "backoff-cap":
        a, b = F("a", fail=True), F("b")
        router, req, _ = _placement(ns, [a, b], fail_threshold=1, revive_sec=1.0)
        router.submit(req(list(range(4))))
        s = router._states[0]
        a.probe_ok = False
        for _ in range(8):
            s.evicted_at = time.monotonic() - 1e6
            router._healthy_indices()
        out += [s.revive_backoff, ns.mod.ReplicaRouter._REVIVE_BACKOFF_CAP]
    elif name == "canary-zero-split":
        router, _, _ = _placement(ns, [F("a", 9.0), F("b")])
        router.set_canary(1)
        out += [router.select(_ids(base)) for base in range(0, 40, 8)]
        out.append(router.stats()["router"]["canary"])
        router.clear_canary()
        out += [router.canary_index, router.select(_ids(0))]
    elif name == "canary-full-split":
        router, _, _ = _placement(ns, [F("a"), F("b", 50.0)])
        router.set_canary(1, traffic_frac=1.0, seed=3)
        out += [router.select(_ids(0)) for _ in range(5)]
        out += [router.canary_routed, router.stats()]
    elif name == "canary-seeded-split":
        router, _, _ = _placement(ns, [F("a"), F("b")])
        router.set_canary(0, traffic_frac=0.3, seed=11)
        out += [router.select(_ids(8 * (i % 5))) for i in range(40)]
        out.append(router.stats())
    elif name == "canary-validation":
        router, _, _ = _placement(ns, [F("a"), F("b")])
        out += [_try(lambda: router.set_canary(7)),
                _try(lambda: router.set_canary(0, traffic_frac=1.5))]
    elif name == "sole-replica-as-canary":
        a, b = F("a", fail=True), F("b")
        router, req, served_by = _placement(ns, [a, b], fail_threshold=3, revive_sec=60.0)
        router.set_canary(1)
        r = router.submit(req(list(range(4))))
        out += [r.finish_reason, served_by(r), router.failovers]
    elif name == "failover-prefers-proven":
        a, b, c = F("a", fail=True), F("b", 5.0), F("c")
        router, req, served_by = _placement(ns, [a, b, c], fail_threshold=3, revive_sec=60.0)
        router.set_canary(2)
        r = router.submit(req(list(range(4))))
        out += [served_by(r), len(c.served)]
    elif name == "epochs-converged":
        router, _, _ = _placement(ns, [F("a", step=100, epoch=1), F("b", step=100, epoch=2)])
        out.append(router.stats())
    elif name == "epochs-mixed":
        router, _, _ = _placement(ns, [F("a", step=100, epoch=1), F("b", step=200, epoch=1)])
        out.append(router.stats()["router"]["epoch_divergence"])
    elif name == "epochs-evicted-ignored":
        a, b = F("a", fail=True, step=100), F("b", step=200)
        router, req, _ = _placement(ns, [a, b], fail_threshold=1, revive_sec=60.0)
        router.submit(req(list(range(4))))
        out.append(router.stats()["router"]["epoch_divergence"])
    elif name == "epoch-gauges":
        registry = ns.Registry()
        router, _, _ = _placement(ns, [F("a", step=1), F("b", step=2)], registry=registry)
        router.stats()
        out.append(dict(registry.latest()))
    elif name == "reload-one-replica":
        a, b = F("a"), F("b")
        router, _, _ = _placement(ns, [a, b])
        out += [router.reload_replica(1, params=object(), step=9), a.reloads, b.reloads]
    elif name == "reload-replica-errors":
        a = F("a")
        router, _, _ = _placement(ns, [a])
        out.append(_try(lambda: router.reload_replica(3, params=object())))
        a.reload_error = "bad payload"
        out.append(_try(lambda: router.reload_replica(0, params=object())))
    return out


SCENARIOS = [
    "requires-a-replica", "least-loaded", "affinity-until-load-gap", "distinct-prefixes",
    "affinity-lru-cap", "failover-then-eviction", "all-down", "revives-on-probe",
    "rolling-reload", "stats-and-fleet-hit-rate", "prometheus-gauges", "resolve-literal-host",
    "revival-backoff", "backoff-cap", "canary-zero-split", "canary-full-split",
    "canary-seeded-split", "canary-validation", "sole-replica-as-canary",
    "failover-prefers-proven", "epochs-converged", "epochs-mixed", "epochs-evicted-ignored",
    "epoch-gauges", "reload-one-replica", "reload-replica-errors",
]


@pytest.mark.parametrize("name", SCENARIOS)
def test_router_scenario_answers_as_jax(name: str) -> None:
    ours = _scenario(name, ROUTERS["port"])
    theirs = _scenario(name, ROUTERS["jax"])
    assert ours == theirs and ours


# ------------------------------------------------------------ real engines

_TINY = dict(vocab_size=64, block_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64)


@pytest.fixture(scope="module")
def weights():
    """Two weight sets of one tiny model: (JAX model, [params A, params B],
    [port model A, port model B])."""
    sets = [jax_gpt(seed=s, **_TINY) for s in (3, 4)]
    jm = sets[0][0]
    return jm, [p for _, p in sets], [port_gpt(jm, p) for _, p in sets]


def _replica(model, name: str, timeline=None) -> InProcessReplica:
    engine = PagedDecodeEngine(model, block_tokens=8, max_batch_slots=4, prefix_cache=True,
                               prefill_chunk=8)
    sched = ContinuousBatchingScheduler(engine, registry=PortRegistry(), timeline=timeline)
    return InProcessReplica(sched.start(), name)


def _wait(reqs, timeout: float = 120.0) -> None:
    for r in reqs:
        assert r.done.wait(timeout), r.request_id


def _wait_swapped(router, epoch: int, timeout: float = 60.0) -> None:
    """Until every replica admits on ``epoch`` (a swap applies between its
    scheduler's steps)."""
    deadline = time.monotonic() + timeout
    while any(rep.scheduler.stats()["params"]["epoch"] < epoch for rep in router.replicas):
        assert time.monotonic() < deadline, "the reload never applied"
        time.sleep(0.001)


def test_two_replica_drill_with_rolling_reload(weights) -> None:
    jm, params, models = weights
    router = ReplicaRouter([_replica(models[0], f"replica{i}", EventTimeline(None))
                            for i in range(2)], block_tokens=8, timeline=EventTimeline(None))
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(0, 64, 16) for _ in range(2)]
    reqs = []
    for i in range(16):
        prompt = np.concatenate([prefixes[i % 2], rng.integers(0, 64, 8)]).astype(np.int32)
        sampled = i % 3 == 0
        reqs.append(ServeRequest(prompt_ids=prompt, max_new_tokens=6, seed=100 + i,
                                 temperature=0.8 if sampled else 0.0,
                                 top_k=5 if sampled else None))
    try:
        for r in reqs[:8]:
            router.submit(r)
        _wait(reqs[:2])
        results = router.rolling_reload(params=models[1], step=2, checkpoint="b")
        _wait_swapped(router, 1)
        for r in reqs[8:]:
            router.submit(r)
        _wait(reqs)
        stats = router.stats()
    finally:
        router.close()
    assert [r["replica"] for r in results] == ["replica0", "replica1"]
    assert all(r.error is None and r.finish_reason == "length" for r in reqs)
    fleet = stats["router"]
    assert all(rep["routed"] >= 1 for rep in fleet["replicas"])
    assert fleet["affinity_routed"] > 0 and fleet["fleet_prefix"]["hit_rate"] > 0
    assert [rep["param_step"] for rep in fleet["replicas"]] == [2, 2]
    epochs = {r.params_step for r in reqs}
    assert epochs == {None, 2}, epochs  # requests admitted under both weight sets
    greedy: dict = {}
    for r in reqs:
        w = 0 if r.params_step is None else 1
        gen = torch.Generator().manual_seed(r.seed)
        want = generate(models[w], r.prompt_ids[None], max_new_tokens=6, generator=gen,
                        temperature=r.temperature, top_k=r.top_k)
        assert r.tokens == want[0, 24:].tolist(), r.request_id
        if r.temperature == 0.0:
            greedy.setdefault(w, []).append(r)
    for w, rs in greedy.items():
        theirs = jax_generate(jm, params[w], np.stack([r.prompt_ids for r in rs]),
                              max_new_tokens=6, temperature=0.0)
        assert [r.tokens for r in rs] == np.asarray(theirs)[:, 24:].tolist()


def test_reload_never_mutates_the_module_an_old_epoch_reads(weights) -> None:
    _, _, models = weights
    old, new = models
    before = {k: v.clone() for k, v in old.state_dict().items()}
    replicas = [_replica(old, f"replica{i}") for i in range(2)]
    router = ReplicaRouter(replicas, block_tokens=8)
    prompt = np.arange(3, 27, dtype=np.int32)
    long = ServeRequest(prompt_ids=prompt, max_new_tokens=38)
    try:
        router.submit(long)
        deadline = time.monotonic() + 60
        while not long.tokens and time.monotonic() < deadline:
            time.sleep(0.001)
        router.rolling_reload(params=new, step=7)
        _wait_swapped(router, 1)
        assert not long.done.is_set(), "the long request finished before the reload"
        after = ServeRequest(prompt_ids=prompt, max_new_tokens=6)
        router.submit(after)
        _wait([long, after])
    finally:
        router.close()
    assert long.params_step is None and after.params_step == 7
    assert all(torch.equal(v, before[k]) for k, v in old.state_dict().items())
    assert all(rep.scheduler.engine.params is new for rep in replicas)
    assert long.tokens == generate(old, prompt[None], max_new_tokens=38,
                                   temperature=0.0)[0, 24:].tolist()
    assert after.tokens == generate(new, prompt[None], max_new_tokens=6,
                                    temperature=0.0)[0, 24:].tolist()


class _HTTPReplica:
    """One serving process of the drill: scheduler + HTTP server + its own
    file-backed timeline, tracer keeping every trace."""

    def __init__(self, model, trace_dir, name: str) -> None:
        self.timeline = EventTimeline(trace_dir / name / "timeline.jsonl")
        engine = PagedDecodeEngine(model, block_tokens=4, max_batch_slots=4,
                                   prompt_buckets=[8, 16], batch_buckets=[2, 4])
        self.registry = PortRegistry()
        self.scheduler = ContinuousBatchingScheduler(
            engine, registry=self.registry, timeline=self.timeline,
            tracer=Tracer(self.timeline, sampler=TailSampler(warmup=10_000)),
        ).start()
        state = ServerState(model=model, tokenizer=None, step=1, checkpoint="mem://tiny",
                            max_new_tokens_cap=16, default_max_new_tokens=4,
                            scheduler=self.scheduler, registry=self.registry)
        self.httpd = make_server(state, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.scheduler.close()


def _dead_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_fleet_trace_rebuilds_the_cross_process_tree(weights, tmp_path) -> None:
    model = weights[2][0]
    replicas = [_HTTPReplica(model, tmp_path, f"replica{i}") for i in range(2)]
    router_tl = EventTimeline(tmp_path / "router" / "timeline.jsonl")
    backends = [HTTPReplica(f"http://127.0.0.1:{_dead_port()}", "dead", timeout_sec=30.0,
                            probe_timeout_sec=1.0)]
    backends += [HTTPReplica(r.url, f"replica{i}") for i, r in enumerate(replicas)]
    router = ReplicaRouter(backends, fail_threshold=1, revive_sec=600.0, block_tokens=4,
                           timeline=router_tl,
                           tracer=Tracer(router_tl, sampler=TailSampler(warmup=10_000)))
    reqs = build_requests(num_requests=8, seed=3, vocab_size=64, prompt_tokens_min=4,
                          prompt_tokens_max=8, max_new_tokens=4)
    try:
        block = run_loadgen(router, reqs, rate_rps=30.0, seed=5, timeout_sec=300.0)
        stats = router.stats()["router"]
        metrics = []
        for rep in replicas:
            with urllib.request.urlopen(rep.url + "/metrics", timeout=30) as resp:
                metrics.append(resp.read().decode())
    finally:
        router.close()
        for rep in replicas:
            rep.close()
    assert block["requests"]["failed"] == 0 and block["requests"]["completed"] == len(reqs)
    assert stats["failovers"] >= 1 and stats["tracing"]["finished"] == len(reqs)
    assert any('llmtrain_serve_ttft_ms_bucket' in m and '# {trace_id="' in m for m in metrics)

    traces = collect_traces(discover_sources([tmp_path]))
    assert len(traces) == len(reqs)
    failovers = 0
    for trace in traces.values():
        root = trace.root
        assert root is not None and root.name == "router/request"
        assert "router/timeline" in root.source
        hops = [s for s in trace.children(root.span_id) if s.name == "router/http_dispatch"]
        served = [c for h in hops for c in trace.children(h.span_id)
                  if c.name == "serve/request"]
        assert len(served) == 1, format_tree(trace)
        assert "replica" in served[0].source
        names = {c.name for c in trace.children(served[0].span_id)}
        assert {"serve/prefill", "serve/decode_phase"} <= names, format_tree(trace)
        cp = critical_path(trace)
        assert sum(cp["breakdown"].values()) == pytest.approx(cp["total_ms"], abs=0.05)
        if any(s.args.get("error") for s in hops):
            failovers += 1
            assert any(s.name == "router/failover" for s in trace.spans), format_tree(trace)
    assert failovers >= 1


def test_force_header_keeps_a_fast_trace(weights, tmp_path) -> None:
    rep = _HTTPReplica(weights[2][0], tmp_path, "replica0")
    rep.scheduler.tracer = Tracer(rep.timeline,
                                  sampler=TailSampler(slow_frac=0.01, reservoir=16, warmup=0))
    for _ in range(20):
        rep.scheduler.tracer.sampler.decide(60_000.0)
    body = json.dumps({"prompt_ids": [1, 2, 3], "max_new_tokens": 2,
                       "temperature": 0.0}).encode()
    try:
        outs = []
        for headers in ({}, {"X-Trace": "force"}):
            req = urllib.request.Request(rep.url + "/v1/generate", data=body,
                                         headers={"Content-Type": "application/json", **headers})
            with urllib.request.urlopen(req, timeout=120) as resp:
                outs.append(json.loads(resp.read()))
    finally:
        rep.close()
    traces = collect_traces(discover_sources([tmp_path]))
    assert list(traces) == [outs[1]["trace_id"]] and outs[0]["trace_id"] != outs[1]["trace_id"]
    assert traces[outs[1]["trace_id"]].root.args.get("sampled") == "forced"


# ------------------------------------------------ trace across both CLIs

_BENCH_CONFIG = {
    "run": {"name": "trace-x", "seed": 0, "device": "cpu"},
    "model": {"name": "gpt", "dropout": 0.0, "attention": "dense",
              "extra": {"tokenizer": "byte"}, **_TINY},
    "data": {"name": "dummy_text"},
    "trainer": {"max_steps": 1, "warmup_steps": 0},
    "serving": {"mode": "continuous", "max_batch_slots": 2, "block_tokens": 8,
                "prompt_buckets": [8], "batch_buckets": [1, 2]},
    "logging": {"level": "WARNING"},
    "mlflow": {"enabled": False},
}


def test_trace_json_answers_alike_on_both_packages_run_dirs(tmp_path, capsys) -> None:
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({**_BENCH_CONFIG,
                                        "output": {"root_dir": str(tmp_path / "runs")}}))
    cfg, _, resolved = jax_load(cfg_path)
    initialize_registries()
    model = get_model_adapter("gpt")().build_model(cfg)
    params = random_params(model, jnp.zeros((1, 64), jnp.int32), seed=9)
    ckpt = CheckpointManager(tmp_path / "ckpts").save_host(
        1, {"params": serialization.to_state_dict(params), "opt_state": {}}, resolved)
    bench = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt), "--requests", "4",
             "--rate-rps", "100", "--prompt-tokens-min", "4", "--prompt-tokens-max", "8",
             "--max-new-tokens", "3", "--seed", "2"]
    dirs = {"jax": tmp_path / "jax_bench", "port": tmp_path / "port_bench"}
    assert run_cli(jax_cli.main, [*bench, "--out", str(dirs["jax"])]) == 0
    assert run_cli(cli.main, [*bench, "--out", str(dirs["port"])]) == 0
    capsys.readouterr()
    for action in ("summary", "slowest"):
        for writer, run_dir in dirs.items():
            argv = ["trace", action, "--run-dir", str(run_dir), "--json"]
            assert run_cli(jax_cli.main, argv) == 0
            theirs = json.loads(capsys.readouterr().out)
            if writer == "jax":  # the port in a subprocess, as a user runs it
                proc = subprocess.run([sys.executable, "-m", "llmtrain_tpu_torch", *argv],
                                      env=port_env(), capture_output=True, text=True,
                                      timeout=120)
                assert proc.returncode == 0, proc.stderr[-2000:]
                ours = json.loads(proc.stdout)
            else:
                assert run_cli(cli.main, argv) == 0
                ours = json.loads(capsys.readouterr().out)
            assert ours == theirs, (writer, action)
            assert (theirs["traces"] if action == "summary" else len(theirs)) == 4


def test_concurrent_submits_lose_no_placement() -> None:
    """Many threads place requests at once (a short interpreter switch
    interval forces interleaving): every placement is counted once."""
    fakes = [FakeReplica(f"r{i}") for i in range(3)]
    router = ReplicaRouter(fakes, block_tokens=4)
    threads, per_thread = 16, 25
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t: int) -> None:
            for i in range(per_thread):
                router.submit(ServeRequest(prompt_ids=_ids(8 * ((t + i) % 7)),
                                           max_new_tokens=1))

        pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    total = threads * per_thread
    stats = router.stats()["router"]
    assert stats["requests_routed"] == total == sum(r["routed"] for r in stats["replicas"])
    assert sum(len(f.served) for f in fakes) == total
