"""Replica router (the port's copy of ``llmtrain_tpu/serving/router.py``):
prefix-cache-aware, load-aware placement across serving replicas and
rolling (zero-downtime) checkpoint reloads.

One engine serves one card; a FLEET serves traffic. The router turns N
serving replicas — in-process schedulers (one process, each with its own
step thread) or remote HTTP servers — into one endpoint:

* **Prefix-cache-aware placement.** The router hashes each prompt's full
  token blocks with the SAME chain hash the pool's prefix cache uses
  (paged_kv.chain_hashes) and remembers which replica last served each
  block, so a shared system prompt prefills once per fleet, not once per
  replica.
* **Load-aware scoring.** ``score = affinity_weight * matched_blocks −
  load``, load being queue depth + in-flight sequences + KV-pool
  utilization (plus the overload controller's predicted wait and
  brownout), the numbers ``/healthz`` exposes.
* **Health / eviction / failover.** ``fail_threshold`` consecutive submit
  failures evict a replica; it is re-probed after ``revive_sec`` with a
  capped exponential backoff. A failed or 429'd HTTP submit fails over to
  the next-best replica under the fleet's retry budget.
* **Rolling hot swap.** :meth:`rolling_reload` swaps one replica at a time
  (``scheduler.hot_swap`` in process, ``POST /reload`` over HTTP); in-flight
  requests finish on the weights they were admitted under.

In-process replicas share weights: a reload hands every replica the SAME
new model (one module per checkpoint), never loading into the live module,
so a replica's rows pinned to the old epoch keep reading unchanged
weights while both sets are resident.

The router duck-types the scheduler surface (``submit`` / ``stats`` /
``registry`` / ``engine``), so ``make_server`` and ``run_loadgen`` run
unchanged with a router in the scheduler seat. Metrics publish under
``router/*`` (→ ``llmtrain_router_*`` in Prometheus).
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np

from ..telemetry.tracing import TraceContext, Tracer, new_span_id
from ..utils.logging import get_logger
from .overload import REASON_RETRY_BUDGET, RetryBudget, rejected_counter
from .paged_kv import chain_hashes
from .scheduler import ContinuousBatchingScheduler, ServeRequest

logger = get_logger()

# Cap on hashed blocks per prompt: affinity only needs the head of the
# prompt (system prompt / template), not an unbounded hash walk.
_MAX_AFFINITY_BLOCKS = 64

# Overload-aware placement: predicted queue wait converts to load units
# at this rate, and an in-brownout replica carries a flat penalty — a
# browning-out replica should lose placement ties without being treated
# as dead.
_WAIT_MS_PER_LOAD_UNIT = 100.0
_BROWNOUT_LOAD_PENALTY = 5.0
# Load penalty while a replica's 429 backpressure window is open.
_BACKPRESSURE_LOAD_PENALTY = 10.0


class ReplicaBackpressure(Exception):
    """A replica answered 429: overloaded, not dead. The router fails
    the request over (budget permitting) without counting the replica
    toward eviction."""

    def __init__(
        self, name: str, reason: str | None, retry_after: float | None
    ) -> None:
        super().__init__(
            f"replica {name} backpressured"
            + (f" ({reason})" if reason else "")
        )
        self.replica_name = name
        self.reason = reason
        self.retry_after = retry_after


class InProcessReplica:
    """A serving replica living in this process: one scheduler + engine."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, name: str) -> None:
        self.scheduler = scheduler
        self.name = name

    @property
    def engine(self):
        return self.scheduler.engine

    def submit(self, req: ServeRequest) -> None:
        self.scheduler.submit(req)

    def load(self) -> float:
        """Scalar load for placement: queued + in-flight sequences plus
        the KV pool's utilization (a nearly-full pool should lose ties
        even at equal occupancy — its next admission may have to wait)."""
        s = self.scheduler
        with s._lock:
            depth = len(s._queue)
        load = float(depth + len(s._active) + len(s._prefilling))
        if s.engine is not None:
            load += s.engine.pool.stats()["utilization"]
        ov = getattr(s, "_overload", None)
        if ov is not None:
            # Backpressure-aware placement: predicted queue wait and the
            # brownout flag push traffic toward calmer replicas.
            load += ov.predicted_wait_ms(depth) / _WAIT_MS_PER_LOAD_UNIT
            if ov.in_brownout:
                load += _BROWNOUT_LOAD_PENALTY
        return load

    def stats(self) -> dict[str, Any]:
        return self.scheduler.stats()

    def reload(
        self,
        *,
        params: Any | None = None,
        step: int | None = None,
        checkpoint: str | None = None,
    ) -> dict[str, Any]:
        """Hot-swap this replica to ``params``: the new model (JAX's
        name for the argument). The same module may be handed to every
        replica; it is never the module an older epoch still reads."""
        if params is None:
            raise ValueError("in-process reload needs the loaded params")
        self.scheduler.hot_swap(params, step=step, checkpoint=checkpoint)
        return {"replica": self.name, "step": step, "checkpoint": checkpoint}

    def healthcheck(self) -> bool:
        thread = self.scheduler._thread
        return thread is None or thread.is_alive()

    def close(self) -> None:
        self.scheduler.close()


class HTTPReplica:
    """A remote serving replica behind ``POST /v1/generate`` (a k8s pod).

    ``submit`` is asynchronous like the scheduler's: the blocking POST
    runs on a short-lived thread that fills the request's result fields
    and sets ``done`` — the waiting handler/loadgen code is identical
    for both replica kinds. Load comes from the replica's ``/healthz``
    scheduler block, cached for ``poll_sec`` so placement doesn't pay a
    network round-trip per request.
    """

    def __init__(
        self, base_url: str, name: str | None = None, *,
        timeout_sec: float = 120.0, poll_sec: float = 2.0,
        probe_timeout_sec: float = 10.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.name = name or self.base_url
        self.timeout_sec = float(timeout_sec)
        self.poll_sec = float(poll_sec)
        # Health/stats probes get their own (short) timeout so a wedged
        # replica cannot stall the router's health sweep for the full
        # request timeout (router.probe_timeout_sec).
        self.probe_timeout_sec = float(probe_timeout_sec)
        self._inflight = 0
        self._lock = threading.Lock()
        self._cached_load = 0.0
        self._cached_at = 0.0
        # monotonic deadline of the replica's open 429 window; placement
        # penalizes it until then.
        self._backpressure_until = 0.0

    engine = None  # remote: the router cannot pre-validate against it

    def _get(self, path: str) -> dict[str, Any]:
        with urllib.request.urlopen(
            self.base_url + path,
            timeout=min(self.probe_timeout_sec, self.timeout_sec),
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _post(
        self,
        path: str,
        body: dict[str, Any],
        headers: dict[str, str] | None = None,
    ) -> dict[str, Any]:
        data = json.dumps(body).encode("utf-8")
        request = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        with urllib.request.urlopen(request, timeout=self.timeout_sec) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def perform(
        self, req: ServeRequest, *, traceparent: str | None = None
    ) -> None:
        """Blocking POST, called on the router's submit thread; raises on
        transport errors so the router can fail over. A 429 raises
        :class:`ReplicaBackpressure` (request fields untouched, so a
        failover re-perform is clean) and opens the replica's
        backpressure window. ``traceparent`` carries the router's hop
        span across the wire so the replica's spans parent under it."""
        body: dict[str, Any] = {
            "prompt_ids": [int(t) for t in req.prompt_ids],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "seed": int(req.seed),
        }
        if req.top_k is not None:
            body["top_k"] = int(req.top_k)
        if req.top_p is not None:
            body["top_p"] = float(req.top_p)
        if req.eos_token_id is not None:
            body["eos_token_id"] = int(req.eos_token_id)
        headers: dict[str, str] = {}
        if traceparent:
            headers["traceparent"] = traceparent
        if req.rid:
            headers["X-Request-Id"] = str(req.rid)
        if req.priority:
            headers["X-Priority"] = str(req.priority)
        if req.deadline_ms is not None and req.deadline_ms > 0:
            # Propagate the REMAINING budget: time already spent in the
            # router must not be granted again by the replica.
            elapsed_ms = (
                (time.monotonic() - req.submitted_t) * 1e3
                if req.submitted_t > 0
                else 0.0
            )
            remaining = max(1.0, req.deadline_ms - elapsed_ms)
            headers["X-Deadline-Ms"] = f"{remaining:.1f}"
        try:
            out = self._post("/v1/generate", body, headers)
        except urllib.error.HTTPError as exc:
            if exc.code == 429:
                reason, retry_after = self._parse_backpressure(exc)
                with self._lock:
                    self._backpressure_until = time.monotonic() + retry_after
                raise ReplicaBackpressure(
                    self.name, reason, retry_after
                ) from exc
            raise
        finally:
            with self._lock:
                self._inflight -= 1
        now = time.monotonic()
        req.tokens = [int(t) for t in out.get("completion_ids", [])]
        req.first_token_t = now
        req.token_times = [now] * len(req.tokens)
        req.finish_reason = out.get("finish_reason", "length")
        req.finished_t = now
        req.done.set()

    @staticmethod
    def _parse_backpressure(
        exc: urllib.error.HTTPError,
    ) -> tuple[str | None, float]:
        """Reason + retry-after seconds from a 429 (header first, JSON
        body as fallback, 1s when neither parses)."""
        retry_after = 1.0
        header = exc.headers.get("Retry-After") if exc.headers else None
        if header is not None:
            try:
                retry_after = max(0.0, float(header))
            except (TypeError, ValueError):
                pass
        reason = None
        try:
            payload = json.loads(exc.read().decode("utf-8"))
            reason = payload.get("reason")
            if header is None and isinstance(
                payload.get("retry_after"), (int, float)
            ):
                retry_after = max(0.0, float(payload["retry_after"]))
        except Exception:  # noqa: BLE001 — body parse is best-effort
            pass
        return reason, retry_after

    def submit(self, req: ServeRequest) -> None:
        req.submitted_t = time.monotonic()
        req.submitted_pc = time.perf_counter()
        with self._lock:
            self._inflight += 1
        # The router calls perform() itself (failover needs the error);
        # this direct path exists for scheduler-compatible callers.
        threading.Thread(
            target=self._perform_logged, args=(req,), daemon=True
        ).start()

    def _perform_logged(self, req: ServeRequest) -> None:
        try:
            self.perform(req)
        except Exception as exc:  # noqa: BLE001 — surface on the request
            logger.warning("replica %s failed: %s", self.name, exc)
            req.error = str(exc)
            req.finish_reason = "error"
            req.finished_t = time.monotonic()
            req.done.set()

    def load(self) -> float:
        with self._lock:
            inflight = self._inflight
            backpressure_until = self._backpressure_until
        now = time.monotonic()
        if now - self._cached_at > self.poll_sec:
            try:
                sched = self._get("/healthz").get("scheduler", {})
                load = float(
                    sched.get("queue_depth", 0)
                    + sched.get("active_sequences", 0)
                    + sched.get("prefilling_sequences", 0)
                    + sched.get("kv_pool", {}).get("utilization", 0.0)
                )
                ov = sched.get("overload")
                if isinstance(ov, dict):
                    # The replica's own backpressure signal: predicted
                    # queue wait + brownout flag from /healthz.
                    load += (
                        float(ov.get("predicted_wait_ms", 0.0))
                        / _WAIT_MS_PER_LOAD_UNIT
                    )
                    if ov.get("in_brownout"):
                        load += _BROWNOUT_LOAD_PENALTY
                self._cached_load = load
                self._cached_at = now
            except Exception:  # noqa: BLE001 — health probe is best-effort
                pass
        total = self._cached_load + inflight
        if now < backpressure_until:
            # The replica 429'd recently: keep traffic off it until its
            # Retry-After window closes.
            total += _BACKPRESSURE_LOAD_PENALTY
        # In-flight submits routed here but not yet visible in the remote
        # queue stats keep bursts from all landing on one replica.
        return total

    def stats(self) -> dict[str, Any]:
        try:
            return self._get("/healthz").get("scheduler", {})
        except Exception as exc:  # noqa: BLE001
            return {"error": str(exc)}

    def reload(
        self,
        *,
        params: Any | None = None,
        step: int | None = None,
        checkpoint: str | None = None,
    ) -> dict[str, Any]:
        body: dict[str, Any] = {}
        if checkpoint is not None:
            body["checkpoint"] = checkpoint
        out = self._post("/reload", body)
        out.setdefault("replica", self.name)
        return out

    def healthcheck(self) -> bool:
        try:
            return self._get("/healthz").get("status") == "ok"
        except Exception:  # noqa: BLE001
            return False

    def close(self) -> None:
        pass


class _ReplicaState:
    """Router-side health bookkeeping for one replica."""

    def __init__(self, replica: Any) -> None:
        self.replica = replica
        self.healthy = True
        self.consecutive_failures = 0
        self.evicted_at = 0.0
        self.routed = 0
        self.failures = 0
        # Revival-probe bookkeeping: each FAILED probe doubles the wait
        # before the next one (capped), so a dead replica is not
        # re-probed on every placement call.
        self.revive_backoff = 1.0
        self.revive_probes = 0


class ReplicaRouter:
    """Load- and prefix-aware dispatch across serving replicas.

    Duck-types the scheduler surface (``submit``/``stats``/``registry``/
    ``engine``) so the HTTP server and load harness run unchanged with a
    router in the scheduler seat.
    """

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        registry: Any | None = None,
        affinity_weight: float = 4.0,
        max_affinity_entries: int = 4096,
        fail_threshold: int = 3,
        revive_sec: float = 10.0,
        block_tokens: int | None = None,
        retry_budget: int = 0,
        retry_window_sec: float = 10.0,
        timeline: Any | None = None,
        tracer: Tracer | None = None,
    ) -> None:
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.registry = registry
        # Distributed tracing: the router mints each request's root span
        # (``router/request``) and flushes kept traces to its own
        # timeline; replica hops parent under it via traceparent headers.
        self.timeline = timeline
        self.tracer = tracer if tracer is not None else (
            Tracer(timeline) if timeline is not None else None
        )
        self.affinity_weight = float(affinity_weight)
        self.max_affinity_entries = int(max_affinity_entries)
        self.fail_threshold = int(fail_threshold)
        self.revive_sec = float(revive_sec)
        # Fleet-wide failover retry budget: an overloaded fleet must not
        # be DDoS'd by its own router re-sending every 429. 0 = unlimited
        # (the pre-overload-control behavior).
        self._retry_budget = (
            RetryBudget(int(retry_budget), float(retry_window_sec))
            if retry_budget > 0
            else None
        )
        self.retry_window_sec = float(retry_window_sec)
        self.retries_rejected = 0
        self._states = [_ReplicaState(r) for r in replicas]
        if block_tokens is None:
            block_tokens = 16
            for r in replicas:
                engine = getattr(r, "engine", None)
                if engine is not None:
                    block_tokens = engine.pool.block_tokens
                    break
        self.block_tokens = int(block_tokens)
        self._lock = threading.Lock()
        # chain hash -> replica index, LRU-capped: the router's model of
        # WHERE each prefix block's K/V most recently landed.
        self._affinity: OrderedDict[str, int] = OrderedDict()
        self.requests_routed = 0
        self.affinity_routed = 0  # placements decided by a prefix match
        self.failovers = 0
        # Canary A/B split (the promote lifecycle's, not yet ported): a seeded
        # fraction of live traffic is steered to the canary replica and
        # the rest of the fleet never sees it in placement.
        self._canary_idx: int | None = None
        self._canary_frac = 0.0
        self._canary_rng = random.Random(0)
        self.canary_routed = 0

    # ------------------------------------------------------------ plumbing

    @property
    def replicas(self) -> list[Any]:
        return [s.replica for s in self._states]

    @property
    def policy(self) -> str:
        """Scheduler-surface compat: what the serve ready line reports."""
        return "router"

    @property
    def engine(self):
        """First healthy in-process engine — the HTTP layer's admission
        validator; None when the fleet is remote (each pod validates)."""
        for s in self._states:
            engine = getattr(s.replica, "engine", None)
            if s.healthy and engine is not None:
                return engine
        return None

    # Failed revival probes back off exponentially up to this multiple
    # of revive_sec — a permanently dead replica costs one probe per
    # _REVIVE_BACKOFF_CAP * revive_sec, not one per placement call.
    _REVIVE_BACKOFF_CAP = 16.0

    def _healthy_indices(self) -> list[int]:
        now = time.monotonic()
        out = []
        for i, s in enumerate(self._states):
            if (
                not s.healthy
                and now - s.evicted_at >= self.revive_sec * s.revive_backoff
            ):
                # Revival probe: one cheap REAL health check (HTTP
                # /healthz for remote replicas, scheduler-thread-alive
                # for in-process ones), not a request. Elapsed time
                # alone never reinstates a replica.
                s.revive_probes += 1
                if s.replica.healthcheck():
                    logger.info("router: replica %s revived", s.replica.name)
                    s.healthy = True
                    s.consecutive_failures = 0
                    s.revive_backoff = 1.0
                else:
                    # Still dead: stay evicted, restart the clock and
                    # widen the probe interval.
                    s.evicted_at = now
                    s.revive_backoff = min(
                        s.revive_backoff * 2.0, self._REVIVE_BACKOFF_CAP
                    )
                    logger.warning(
                        "router: replica %s failed revival probe %d; next "
                        "probe in %.1fs",
                        s.replica.name, s.revive_probes,
                        self.revive_sec * s.revive_backoff,
                    )
            if s.healthy:
                out.append(i)
        return out

    def _note_failure(self, idx: int, exc: Exception) -> None:
        s = self._states[idx]
        s.failures += 1
        s.consecutive_failures += 1
        logger.warning(
            "router: replica %s failure %d/%d: %s",
            s.replica.name, s.consecutive_failures, self.fail_threshold, exc,
        )
        if s.consecutive_failures >= self.fail_threshold and s.healthy:
            s.healthy = False
            s.evicted_at = time.monotonic()
            logger.warning("router: replica %s evicted", s.replica.name)

    def _note_success(self, idx: int) -> None:
        self._states[idx].consecutive_failures = 0

    # ----------------------------------------------------------- placement

    def _matched_blocks(self, hashes: list[str], idx: int) -> int:
        run = 0
        for h in hashes:
            if self._affinity.get(h) != idx:
                break
            run += 1
        return run

    def _record_affinity(self, hashes: list[str], idx: int) -> None:
        for h in hashes:
            self._affinity[h] = idx
            self._affinity.move_to_end(h)
        while len(self._affinity) > self.max_affinity_entries:
            self._affinity.popitem(last=False)

    # -------------------------------------------------------------- canary

    def set_canary(
        self, idx: int, *, traffic_frac: float = 0.0, seed: int = 0
    ) -> None:
        """Mark replica ``idx`` as the canary: a seeded ``traffic_frac``
        of live requests is steered to it; the rest of the fleet serves
        everything else (the A/B split of the promote soak window).
        With ``traffic_frac=0`` the canary is simply excluded from
        placement — only the controller's synthetic probes reach it."""
        if not 0 <= idx < len(self._states):
            raise ValueError(f"router: no replica index {idx}")
        if not 0.0 <= traffic_frac <= 1.0:
            raise ValueError("traffic_frac must be in [0, 1]")
        with self._lock:
            self._canary_idx = idx
            self._canary_frac = float(traffic_frac)
            self._canary_rng = random.Random(seed)

    def clear_canary(self) -> None:
        with self._lock:
            self._canary_idx = None
            self._canary_frac = 0.0

    @property
    def canary_index(self) -> int | None:
        return self._canary_idx

    def select(self, prompt_ids: np.ndarray) -> int:
        """Pick the replica index for a prompt (placement only, no
        dispatch — exposed for tests and dry-runs). Raises RuntimeError
        when every replica is evicted."""
        healthy = self._healthy_indices()
        canary = self._canary_idx
        if canary is not None and canary in healthy and len(healthy) > 1:
            if self._canary_frac > 0 and (
                self._canary_rng.random() < self._canary_frac
            ):
                # A/B split: this request is the canary's.
                with self._lock:
                    self.requests_routed += 1
                    self.canary_routed += 1
                    self._states[canary].routed += 1
                return canary
            healthy = [i for i in healthy if i != canary]
        if not healthy:
            raise RuntimeError("router: no healthy replicas")
        hashes = chain_hashes(
            [int(t) for t in prompt_ids[: _MAX_AFFINITY_BLOCKS * self.block_tokens]],
            self.block_tokens,
        )
        with self._lock:
            scored = []
            for i in healthy:
                matched = self._matched_blocks(hashes, i) if hashes else 0
                load = self._states[i].replica.load()
                # Affinity wins until the preferred replica is
                # ~affinity_weight*matched requests busier than a peer.
                scored.append((self.affinity_weight * matched - load, matched, i))
            score, matched, best = max(scored, key=lambda t: (t[0], -t[2]))
            self._record_affinity(hashes, best)
            self.requests_routed += 1
            if matched > 0:
                self.affinity_routed += 1
            self._states[best].routed += 1
        return best

    # ------------------------------------------------------------ dispatch

    def submit(self, req: ServeRequest) -> ServeRequest:
        t_mono = time.monotonic()
        t_pc = time.perf_counter()
        if self.tracer is not None and req.trace is None:
            req.trace = self.tracer.start(root_name="router/request")
        idx = self.select(req.prompt_ids)
        replica = self._states[idx].replica
        if req.trace is not None:
            req.trace.add_span(
                "router/place",
                t0=t_pc,
                t1=time.perf_counter(),
                replica=replica.name,
                request_id=req.request_id,
            )
        if isinstance(replica, HTTPReplica):
            # Stamp at router entry so the root span (and latency) cover
            # placement, not just the HTTP hop.
            req.submitted_t = t_mono
            req.submitted_pc = t_pc
            with replica._lock:
                replica._inflight += 1
            threading.Thread(
                target=self._perform_http,
                args=(req, idx),
                daemon=True,
            ).start()
            return req
        try:
            replica.submit(req)
            self._note_success(idx)
        except Exception as exc:  # noqa: BLE001 — failover before erroring
            self._note_failure(idx, exc)
            return self._failover(req, exclude={idx}, cause=exc)
        return req

    def _perform_http(self, req: ServeRequest, idx: int) -> None:
        replica = self._states[idx].replica
        hop_t0 = time.perf_counter()
        traceparent: str | None = None
        hop_sid: str | None = None
        if req.trace is not None:
            # Pre-allocate the hop span id: the replica needs it in the
            # traceparent header BEFORE the hop completes so its own
            # spans can parent under this dispatch.
            hop = TraceContext(
                req.trace.trace_id,
                new_span_id(),
                req.trace.root_span_id,
                req.trace.ctx.forced,
            )
            traceparent = hop.to_traceparent()
            hop_sid = hop.span_id
        try:
            replica.perform(req, traceparent=traceparent)
            self._note_success(idx)
            self._hop_done(req, hop_t0, hop_sid, replica.name)
            self._finish_trace(req)
        except ReplicaBackpressure as exc:
            # 429 = overloaded, not dead: no eviction strike; the replica
            # already opened its backpressure window for placement.
            logger.warning(
                "router: replica %s backpressured request %s (%s)",
                replica.name, req.request_id, exc.reason,
            )
            self._hop_done(
                req, hop_t0, hop_sid, replica.name,
                error=f"backpressure:{exc.reason or 'overloaded'}",
            )
            try:
                self._failover(req, exclude={idx}, cause=exc)
            except Exception as exc2:  # noqa: BLE001 — out of replicas
                req.error = str(exc2)
                req.finish_reason = "error"
                req.finished_t = time.monotonic()
                self._finish_trace(req)
                req.done.set()
        except Exception as exc:  # noqa: BLE001 — transport error: failover
            self._note_failure(idx, exc)
            self._hop_done(
                req, hop_t0, hop_sid, replica.name, error=str(exc)
            )
            try:
                self._failover(req, exclude={idx}, cause=exc)
            except Exception as exc2:  # noqa: BLE001 — out of replicas
                req.error = str(exc2)
                req.finish_reason = "error"
                req.finished_t = time.monotonic()
                self._finish_trace(req)
                req.done.set()

    def _hop_done(
        self,
        req: ServeRequest,
        t0: float,
        span_id: str | None,
        replica_name: str,
        error: str | None = None,
    ) -> None:
        """Buffer the router→replica HTTP hop span (failed hops too — a
        trace that failed over shows every attempt, not just the winner)."""
        if req.trace is None:
            return
        args: dict[str, Any] = {"replica": replica_name}
        if error is not None:
            args["error"] = error
        req.trace.add_span(
            "router/http_dispatch",
            t0=t0,
            t1=time.perf_counter(),
            span_id=span_id,
            **args,
        )

    def _finish_trace(self, req: ServeRequest) -> None:
        """Resolve the request's trace on the router's completion path
        (HTTP hops only — in-process replicas finish via their
        scheduler; Tracer.finish is idempotent either way)."""
        if self.tracer is None or req.trace is None:
            return
        t1 = time.perf_counter()
        root_args: dict[str, Any] = {
            "request_id": req.request_id,
            "finish_reason": req.finish_reason,
        }
        if req.rid:
            root_args["rid"] = req.rid
        if req.ttft_ms is not None:
            root_args["ttft_ms"] = round(req.ttft_ms, 3)
        self.tracer.finish(
            req.trace,
            t0=req.submitted_pc if req.submitted_pc > 0.0 else t1,
            t1=t1,
            errored=req.error is not None or req.finish_reason == "error",
            **root_args,
        )

    def _reject_retry(self, req: ServeRequest, cause: Exception) -> None:
        """Retry budget exhausted: finish the request as rejected (fast,
        honest 429 to the client) instead of re-hammering the fleet."""
        with self._lock:
            self.retries_rejected += 1
        req.reject_reason = REASON_RETRY_BUDGET
        req.retry_after_sec = (
            getattr(cause, "retry_after", None) or self.retry_window_sec
        )
        req.finish_reason = "rejected"
        req.finished_t = time.monotonic()
        if self.registry is not None:
            self.registry.inc(rejected_counter(REASON_RETRY_BUDGET))
        logger.warning(
            "router: retry budget exhausted; rejecting request %s (%s)",
            req.request_id, cause,
        )
        if req.trace is not None:
            req.trace.note(reject_reason=REASON_RETRY_BUDGET)
        self._finish_trace(req)
        req.done.set()

    def _failover(
        self, req: ServeRequest, *, exclude: set[int], cause: Exception
    ) -> ServeRequest:
        if self._retry_budget is not None and not self._retry_budget.try_spend():
            self._reject_retry(req, cause)
            return req
        healthy = [i for i in self._healthy_indices() if i not in exclude]
        if self._canary_idx is not None and len(healthy) > 1:
            # Never fail live traffic over onto an unproven canary while
            # a proven replica remains.
            healthy = [i for i in healthy if i != self._canary_idx] or healthy
        if not healthy:
            raise RuntimeError(
                f"router: no healthy replica left for failover ({cause})"
            )
        idx = min(healthy, key=lambda i: self._states[i].replica.load())
        with self._lock:
            self.failovers += 1
            self._states[idx].routed += 1
        replica = self._states[idx].replica
        logger.warning(
            "router: failing request %s over to %s", req.request_id,
            replica.name,
        )
        if req.trace is not None:
            # A failed-over request is always trace-worthy; forcing also
            # propagates the keep decision to the retry hop's replica.
            req.trace.note(failover=True)
            req.trace.force()
            req.trace.add_event(
                "router/failover",
                t=time.perf_counter(),
                replica=replica.name,
                cause=str(cause),
            )
        if isinstance(replica, HTTPReplica):
            with replica._lock:
                replica._inflight += 1
            self._perform_http(req, idx)
            return req
        replica.submit(req)
        self._note_success(idx)
        return req

    # ------------------------------------------------------------ hot swap

    def rolling_reload(
        self,
        *,
        params: Any | None = None,
        step: int | None = None,
        checkpoint: str | None = None,
    ) -> list[dict[str, Any]]:
        """Apply a checkpoint swap ONE replica at a time. Each replica's
        own hot-swap contract (in-flight finishes on old params, new
        admissions on new) makes the roll zero-downtime: at every moment
        every replica is serving, some on the old checkpoint, some on
        the new — exactly a k8s rolling update, without restarting
        anything or dropping a request."""
        results = []
        for idx, s in enumerate(self._states):
            if not s.healthy:
                results.append(
                    {"replica": s.replica.name, "skipped": "evicted"}
                )
                continue
            try:
                results.append(
                    s.replica.reload(
                        params=params, step=step, checkpoint=checkpoint
                    )
                )
                self._note_success(idx)
            except Exception as exc:  # noqa: BLE001 — roll on; report
                self._note_failure(idx, exc)
                results.append({"replica": s.replica.name, "error": str(exc)})
        return results

    def reload_replica(
        self,
        idx: int,
        *,
        params: Any | None = None,
        step: int | None = None,
        checkpoint: str | None = None,
    ) -> dict[str, Any]:
        """Hot-swap ONE replica (the canary path: swap a candidate in,
        or roll it back to the promoted baseline). Raises on failure —
        the caller decides whether that aborts a canary or triggers a
        fleet rollback."""
        if not 0 <= idx < len(self._states):
            raise ValueError(f"router: no replica index {idx}")
        s = self._states[idx]
        result = s.replica.reload(params=params, step=step, checkpoint=checkpoint)
        self._note_success(idx)
        return result

    # ----------------------------------------------------------- telemetry

    def stats(self) -> dict[str, Any]:
        """Fleet stats in the scheduler's shape (the load harness reads
        occupancy/policy keys) + a ``router`` block with placement and
        per-replica detail."""
        per_replica = []
        agg = {
            "peak_batch_occupancy": 0,
            "mean_batch_occupancy": 0.0,
            "max_batch_slots": 0,
            "queue_depth": 0,
            "active_sequences": 0,
            "requests_finished": 0,
            "tokens_generated": 0,
        }
        policy = None
        prefix_hits = prefix_queries = prefix_hit_queries = prefix_tokens = 0
        ov_rejected = ov_shed = ov_brownout = 0
        fleet_steps: set[Any] = set()
        for i, s in enumerate(self._states):
            rs = s.replica.stats() if s.healthy else {"evicted": True}
            policy = policy or rs.get("policy")
            ov = rs.get("overload")
            if isinstance(ov, dict):
                ov_rejected += int(ov.get("rejected_total", 0))
                ov_shed += int(ov.get("shed", 0))
                ov_brownout += int(bool(ov.get("in_brownout")))
            for k in agg:
                v = rs.get(k)
                if isinstance(v, (int, float)):
                    agg[k] += v
            pool = rs.get("kv_pool", {})
            prefix_hits += pool.get("prefix_hits", 0)
            prefix_queries += pool.get("prefix_queries", 0)
            prefix_hit_queries += pool.get("prefix_hit_queries", 0)
            prefix_tokens += pool.get("prefix_tokens_reused", 0)
            # Param identity: which checkpoint this replica is ADMITTING
            # on right now. step is comparable fleet-wide; epoch is the
            # replica-local swap counter.
            params_blk = rs.get("params") or {}
            param_step = params_blk.get("step")
            param_epoch = params_blk.get("epoch")
            if s.healthy and (param_step is not None or param_epoch is not None):
                fleet_steps.add(
                    param_step if param_step is not None
                    else f"epoch:{i}:{param_epoch}"
                )
            per_replica.append(
                {
                    "name": s.replica.name,
                    "healthy": s.healthy,
                    "routed": s.routed,
                    "failures": s.failures,
                    "revive_probes": s.revive_probes,
                    "load": s.replica.load() if s.healthy else None,
                    "param_epoch": param_epoch,
                    "param_step": param_step,
                    "stats": rs,
                }
            )
        out: dict[str, Any] = dict(agg)
        out["policy"] = policy or "paged"
        out["mean_batch_occupancy"] = round(agg["mean_batch_occupancy"], 4)
        out["router"] = {
            "replicas": per_replica,
            "replicas_healthy": sum(1 for s in self._states if s.healthy),
            "requests_routed": self.requests_routed,
            "affinity_routed": self.affinity_routed,
            "affinity_entries": len(self._affinity),
            "failovers": self.failovers,
            "affinity_weight": self.affinity_weight,
            # Distinct param steps healthy replicas are serving, minus
            # one: 0 = a converged fleet, >0 = a mixed-epoch fleet (mid
            # rollout, or a partially failed one — the promote
            # controller's fleet-rollback trigger).
            "epoch_divergence": max(0, len(fleet_steps) - 1),
            "canary": {
                "index": self._canary_idx,
                "traffic_frac": self._canary_frac,
                "routed": self.canary_routed,
            },
            "overload": {
                # Fleet-wide overload picture: summed replica counters
                # plus the router's own retry-budget state.
                "rejected_total": ov_rejected,
                "shed": ov_shed,
                "replicas_in_brownout": ov_brownout,
                "retries_rejected": self.retries_rejected,
                "retry_budget_remaining": (
                    self._retry_budget.remaining()
                    if self._retry_budget is not None
                    else None
                ),
            },
            "tracing": (
                self.tracer.stats() if self.tracer is not None else None
            ),
            "fleet_prefix": {
                "hits": prefix_hits,
                "queries": prefix_queries,
                "hit_queries": prefix_hit_queries,
                "tokens_reused": prefix_tokens,
                # hits counts reused BLOCKS (can exceed queries); the rate
                # is the fraction of admissions that reused anything.
                "hit_rate": round(prefix_hit_queries / max(1, prefix_queries), 4),
            },
        }
        self._publish_metrics(out)
        return out

    def _publish_metrics(self, stats: dict[str, Any]) -> None:
        if self.registry is None:
            return
        r = stats["router"]
        gauges = {
            "router/replicas_healthy": float(r["replicas_healthy"]),
            "router/requests_routed": float(r["requests_routed"]),
            "router/affinity_routed": float(r["affinity_routed"]),
            "router/affinity_entries": float(r["affinity_entries"]),
            "router/failovers": float(r["failovers"]),
            "router/fleet_prefix_hit_rate": float(
                r["fleet_prefix"]["hit_rate"]
            ),
            "router/queue_depth": float(stats["queue_depth"]),
            "router/active_sequences": float(stats["active_sequences"]),
            "router/epoch_divergence": float(r["epoch_divergence"]),
            "router/canary_routed": float(r["canary"]["routed"]),
            "router/rejected_total": float(r["overload"]["rejected_total"]),
            "router/shed_total": float(r["overload"]["shed"]),
            "router/replicas_in_brownout": float(
                r["overload"]["replicas_in_brownout"]
            ),
            "router/retries_rejected": float(
                r["overload"]["retries_rejected"]
            ),
        }
        if r["overload"]["retry_budget_remaining"] is not None:
            gauges["router/retry_budget_remaining"] = float(
                r["overload"]["retry_budget_remaining"]
            )
        for i, rep in enumerate(r["replicas"]):
            gauges[f"router/replica{i}_healthy"] = float(bool(rep["healthy"]))
            gauges[f"router/replica{i}_routed"] = float(rep["routed"])
            if rep["load"] is not None:
                gauges[f"router/replica{i}_load"] = float(rep["load"])
            if rep["param_epoch"] is not None:
                gauges[f"router/replica{i}_param_epoch"] = float(
                    rep["param_epoch"]
                )
            if rep["param_step"] is not None:
                gauges[f"router/replica{i}_param_step"] = float(
                    rep["param_step"]
                )
            occ = rep["stats"].get("active_sequences")
            if isinstance(occ, (int, float)):
                gauges[f"router/replica{i}_active_sequences"] = float(occ)
        self.registry.publish(gauges)

    # ----------------------------------------------------------- lifecycle

    def close(self, timeout: float = 30.0) -> None:
        for s in self._states:
            try:
                s.replica.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if self.timeline is not None:
            try:
                self.timeline.flush()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def start(self) -> "ReplicaRouter":
        """Scheduler-API compat: in-process replicas are started where
        they are built; remote ones are already running."""
        return self


def resolve_backends(discover: str) -> list[str]:
    """DNS-resolve ``host:port`` into one base URL per A record — the
    k8s headless-Service discovery path (the Service name resolves to
    every ready pod IP). Falls back to the literal host on resolver
    failure, so a plain hostname keeps working."""
    import socket

    host, _, port = discover.partition(":")
    port = port or "8000"
    try:
        infos = socket.getaddrinfo(host, int(port), proto=socket.IPPROTO_TCP)
        addrs = sorted({info[4][0] for info in infos})
    except OSError:
        addrs = [host]
    return [f"http://{a}:{port}" for a in addrs]


__all__ = [
    "HTTPReplica",
    "InProcessReplica",
    "ReplicaBackpressure",
    "ReplicaRouter",
    "resolve_backends",
]
