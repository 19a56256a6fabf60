"""Continuous (in-flight) batching scheduler over the paged decode engine
(port of ``llmtrain_tpu/serving/scheduler.py``, policy ``paged``).

Requests enter an admission queue from any thread (HTTP handlers, the load
generator); a single scheduler thread runs
:meth:`ContinuousBatchingScheduler.step` in a loop — each step **joins**
queued arrivals whose worst-case KV blocks the pool can guarantee (prefill,
first token), advances every in-flight sequence one token, and **retires**
finishers (EOS / max tokens) without draining the batch. The model runs
only on the scheduler's thread; handler threads only enqueue and wait.

Policies layered on the paged path:

* **Shared-prefix reuse** — at admission the prompt is looked up in the
  pool's content-addressed prefix cache (paged_kv.py); matched blocks bind
  read-only (COW on a partial match) and prefill runs only the unmatched
  SUFFIX at its true offset. After the prompt is fully written, its full
  blocks are registered for later requests.
* **Chunked prefill** — with ``engine.prefill_chunk > 0``, long prompts
  stream into the pool one chunk per step, interleaved with the decode
  batch. Chunks pad into the EXISTING prompt buckets (engine contract).
* **Checkpoint hot-swap** — :meth:`hot_swap` queues a new model; the
  scheduler thread applies it between steps. Every request is pinned at
  admission to its **param epoch**: in-flight sequences finish on the
  model they were admitted under (decode runs grouped by epoch), new
  admissions use the new one, and the prefix cache is invalidated. Two
  parameter sets are resident while an old epoch still has rows.
* **Overload control** (overload.py) — a bounded weighted-class queue,
  deadline-aware rejection at submit, shedding and brownout.

SLO accounting is server-side and per request: submit→first-token (TTFT)
and inter-token gaps, which the load harness (loadgen.py) aggregates.
Metrics publish into the telemetry MetricsRegistry under ``serve/*``
(→ ``llmtrain_serve_*`` in Prometheus).

Not yet ported: the ``speculative`` policy (ROADMAP.md queue A:
speculative decoding) and request tracing with a serving timeline
(ROADMAP.md queue A: telemetry).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..utils.logging import get_logger
from .engine import PagedDecodeEngine
from .overload import (
    REASON_DEADLINE_EXCEEDED,
    OverloadController,
    rejected_counter,
)

logger = get_logger()

_REQ_IDS = itertools.count()
# Every request id is namespaced by a per-process random token — unique
# across replica processes, still ordered within one.
_PROC_TOKEN = os.urandom(4).hex()


def new_request_id() -> str:
    """``{process_token}/{n}``: collision-free across replica processes."""
    return f"{_PROC_TOKEN}/{next(_REQ_IDS)}"


@dataclass
class ServeRequest:
    """One generation request + its server-side measurements."""

    prompt_ids: np.ndarray  # (Tp,) int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0
    eos_token_id: int | None = None
    request_id: str = field(default_factory=new_request_id)
    # Measurements (scheduler-thread writes, reader waits on `done`).
    submitted_t: float = 0.0
    first_token_t: float | None = None
    finished_t: float | None = None
    token_times: list[float] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    error: str | None = None
    # Checkpoint step of the params this request was ADMITTED under
    # (hot-swap audit trail: parity must check against these params).
    params_step: int | None = None
    # Overload control (serving/overload.py): the client's latency budget
    # from submit (X-Deadline-Ms over HTTP), the priority class the
    # weighted admission queue dequeues by, and the client-supplied
    # correlation id (X-Request-Id).
    deadline_ms: float | None = None
    priority: str = "interactive"
    rid: str | None = None
    # Queue depth seen at submit — the EWMA wait estimator's x-axis.
    queue_depth_at_submit: int = 0
    # Set when the overload layer rejected/shed this request: the
    # {reason} label on llmtrain_serve_rejected_total, and the 429
    # Retry-After hint (seconds).
    reject_reason: str | None = None
    retry_after_sec: float | None = None
    done: threading.Event = field(default_factory=threading.Event)
    # Set by a waiter that gave up (HTTP timeout, loadgen deadline): the
    # scheduler sheds the request — queued or in flight — instead of
    # spending device time decoding for a departed client.
    abandoned: threading.Event = field(default_factory=threading.Event)

    def abandon(self) -> None:
        self.abandoned.set()

    @property
    def ttft_ms(self) -> float | None:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.submitted_t) * 1e3

    @property
    def latency_ms(self) -> float | None:
        if self.finished_t is None:
            return None
        return (self.finished_t - self.submitted_t) * 1e3


@dataclass
class _Row:
    """One in-flight sequence's scheduler-side state."""

    req: ServeRequest
    table: Any  # BlockTable
    prompt_len: int
    # Prompt tokens whose K/V is already in the pool (cached prefix +
    # prefilled chunks); == prompt_len once the first token can sample.
    prefilled: int = 0
    # Param epoch pinned at admission: the row decodes on this model until
    # it retires, whatever hot_swap() does meanwhile.
    epoch: int = 0
    # The request's sampling stream (None for a greedy row): seeded with
    # the request's seed, one draw per emitted token, as generate() draws.
    generator: torch.Generator | None = None

    def sampling(self) -> dict[str, Any]:
        req = self.req
        return dict(temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    generator=self.generator)


class ContinuousBatchingScheduler:
    """Admission queue + per-step join/evict over a PagedDecodeEngine."""

    def __init__(
        self,
        engine: PagedDecodeEngine,
        *,
        max_batch_slots: int | None = None,
        registry: Any | None = None,  # telemetry MetricsRegistry
        policy: str = "paged",
        overload: OverloadController | None = None,
        tracer: Any | None = None,
    ) -> None:
        if policy == "speculative":
            raise NotImplementedError(
                "the speculative scheduler policy (continuous serving with a draft "
                "model) is not yet ported to llmtrain_tpu_torch "
                "(ROADMAP.md queue A: speculative decoding)"
            )
        if policy != "paged":
            raise ValueError(
                f"serving policy {policy!r} unknown; expected 'paged' or "
                "'speculative'"
            )
        if tracer is not None:
            raise NotImplementedError(
                "request tracing is not yet ported to llmtrain_tpu_torch "
                "(ROADMAP.md queue A: telemetry)"
            )
        if engine is None:
            raise ValueError("policy='paged' requires a PagedDecodeEngine")
        self.engine = engine
        self.policy = policy
        self.registry = registry
        self.max_batch_slots = int(max_batch_slots or engine.max_batch_slots)

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # With an overload controller the admission queue is its bounded
        # weighted-class queue and submit() can reject synchronously;
        # without one it is an unbounded FIFO.
        self._overload = overload
        self._queue: Any = overload.queue if overload is not None else deque()
        self._active: list[_Row] = []
        # Rows still streaming their prompt in under chunked prefill —
        # they hold a batch slot (their KV is resident) but don't decode.
        self._prefilling: list[_Row] = []
        self._closed = False
        self._thread: threading.Thread | None = None
        # Liveness beacon: monotonic time of the loop thread's last
        # iteration. /healthz turns 503 when this goes stale.
        self._beacon = time.monotonic()

        # Param epochs (checkpoint hot-swap). Epoch 0 is the model the
        # scheduler was built with; hot_swap() appends. Old epochs stay
        # resident only while a row admitted under them is in flight.
        self._param_epoch = 0
        self._params_by_epoch: dict[int, Any] = {0: engine.params}
        self._param_meta: dict[int, dict[str, Any]] = {
            0: {"step": None, "checkpoint": None}
        }
        self._epoch_refs: dict[int, int] = {}
        self._pending_swap: tuple[Any, int | None, str | None] | None = None
        self.hot_swaps = 0

        # Aggregate accounting (scheduler thread only).
        self.requests_finished = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0  # tokens actually COMPUTED (reuse excluded)
        self.peak_occupancy = 0
        self._occupancy_samples = 0
        self._occupancy_total = 0

    # ----------------------------------------------------------- frontend

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Thread-safe enqueue; returns immediately (wait on ``req.done``).

        With an overload controller attached the admission verdict is
        SYNCHRONOUS: a rejected request comes back with ``done`` already
        set, ``finish_reason == "rejected"``, and a ``reject_reason`` /
        ``retry_after_sec`` the HTTP layer maps to 429 + Retry-After."""
        req.submitted_t = time.monotonic()
        verdict: tuple[str, float] | None = None
        with self._wake:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._overload is not None:
                if req.deadline_ms is None and self._overload.default_deadline_ms:
                    req.deadline_ms = self._overload.default_deadline_ms
                depth = len(self._queue)
                req.queue_depth_at_submit = depth
                verdict = self._overload.admission_check(req, depth)
            if verdict is None:
                self._queue.append(req)
                self._wake.notify()
        if verdict is not None:
            reason, retry_after = verdict
            self._reject(req, reason, retry_after=retry_after)
        return req

    def _reject(
        self,
        req: ServeRequest,
        reason: str,
        *,
        retry_after: float | None = None,
        shed: bool = False,
    ) -> None:
        """Finalize an overload rejection: ``rejected`` at submit time,
        ``shed`` for a queued request dropped past its deadline. Every
        rejection lands as a labeled counter."""
        req.reject_reason = reason
        if retry_after is not None:
            req.retry_after_sec = retry_after
        req.finish_reason = "shed" if shed else "rejected"
        req.finished_t = time.monotonic()
        if self._overload is not None:
            self._overload.note_rejection(reason, shed=shed)
        if self.registry is not None:
            self.registry.inc(rejected_counter(reason))
        req.done.set()

    def hot_swap(
        self,
        params: Any,
        *,
        step: int | None = None,
        checkpoint: str | None = None,
    ) -> None:
        """Queue a zero-downtime model swap (thread-safe); the scheduler
        thread applies it BETWEEN steps. In-flight sequences finish on the
        model they were admitted under (per-row epoch pinning); admissions
        after the swap use the new one; the prefix cache is invalidated. No
        request fails or restarts."""
        with self._wake:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._pending_swap = (params, step, checkpoint)
            self._wake.notify()

    # ------------------------------------------------------------- backend

    def _record_queue_wait(self, req: ServeRequest) -> None:
        """The overload estimator's learning signal: the OBSERVED wait at
        the depth the request saw calibrates the predicted wait."""
        if self._overload is not None and req.submitted_t > 0.0:
            self._overload.observe_queue_wait(
                (time.monotonic() - req.submitted_t) * 1e3,
                req.queue_depth_at_submit,
            )

    # -------------------------------------------------------- param epochs

    def _apply_pending_swap(self) -> bool:
        with self._lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return False
        params, step, checkpoint = pending
        self._param_epoch += 1
        self._params_by_epoch[self._param_epoch] = params
        self._param_meta[self._param_epoch] = {
            "step": step, "checkpoint": checkpoint
        }
        self.engine.set_params(params)
        flushed = self.engine.pool.invalidate_prefix_cache()
        if flushed:
            logger.info(
                "serve: hot-swap invalidated %d cached prefix blocks", flushed
            )
        self.hot_swaps += 1
        self._gc_epochs()
        logger.info(
            "serve: hot-swapped params to step %s (epoch %d, %d in flight "
            "pinned to older epochs)",
            step,
            self._param_epoch,
            sum(self._epoch_refs.values()),
        )
        return True

    def _pin_epoch(self, epoch: int) -> None:
        self._epoch_refs[epoch] = self._epoch_refs.get(epoch, 0) + 1

    def _unpin_epoch(self, epoch: int) -> None:
        n = self._epoch_refs.get(epoch, 0) - 1
        if n <= 0:
            self._epoch_refs.pop(epoch, None)
        else:
            self._epoch_refs[epoch] = n
        self._gc_epochs()

    def _gc_epochs(self) -> None:
        """Drop superseded models once their last pinned row retires — a
        swap must not double resident param memory forever."""
        for ep in [
            e
            for e in self._params_by_epoch
            if e != self._param_epoch and self._epoch_refs.get(e, 0) == 0
        ]:
            del self._params_by_epoch[ep]
            self._param_meta.pop(ep, None)

    # ------------------------------------------------------------ stepping

    def step(self) -> bool:
        """One scheduler iteration: join, advance, evict. Returns whether
        any work happened (False = idle)."""
        swapped = self._apply_pending_swap()
        shed = self._overload_tick()
        return self._step_paged() or swapped or shed

    def _overload_tick(self) -> bool:
        """Per-step overload bookkeeping: feed the brownout hysteresis one
        pressure sample, and under sustained overload eagerly shed queued
        requests already past their deadline."""
        ov = self._overload
        if ov is None:
            return False
        with self._lock:
            depth = len(self._queue)
        transition = ov.tick(depth)
        if transition is not None:
            logger.warning(
                "serve: brownout %s (predicted queue wait %.1f ms, "
                "queue depth %d)",
                transition, ov.predicted_wait_ms(depth), depth,
            )
        if not ov.shedding_active:
            return False
        now = time.monotonic()
        with self._lock:
            expired = self._queue.sweep(lambda r: ov.past_deadline(r, now))
        for req in expired:
            self._reject(req, REASON_DEADLINE_EXCEEDED, shed=True)
        return bool(expired)

    def _admit_paged(self, req: ServeRequest) -> _Row | None:
        """Reserve one popped request and pin its epoch. None when the pool
        is full — the caller re-queues."""
        tp = int(req.prompt_ids.shape[0])
        table = self.engine.pool.try_reserve(tp + int(req.max_new_tokens))
        if table is None:
            return None
        row = _Row(req=req, table=table, prompt_len=tp, epoch=self._param_epoch)
        if req.temperature != 0.0:
            row.generator = torch.Generator(device=self.engine.device)
            row.generator.manual_seed(req.seed)
        req.params_step = self._param_meta[row.epoch].get("step")
        self._pin_epoch(row.epoch)
        return row

    def _prefill_next(self, row: _Row, *, limit: int | None = None) -> bool:
        """Prefill the row's next prompt slab (everything remaining, or at
        most ``limit`` tokens under chunked prefill) at its true offset.
        The FINAL slab samples the first output token, registers the
        prompt's full blocks in the prefix cache, and stamps TTFT; a
        non-final chunk samples nothing. On failure the row is failed and
        released — and since the engine zeroed the pool, every in-flight
        row goes with it. Returns success."""
        engine = self.engine
        start = row.prefilled
        end = (
            row.prompt_len
            if limit is None
            else min(row.prompt_len, start + int(limit))
        )
        final = end == row.prompt_len
        engine.pool.grow(row.table, end)
        try:
            tok = engine.prefill(
                row.req.prompt_ids[start:end],
                row.table.padded(engine.max_blocks_per_seq),
                offset=start,
                params=self._params_by_epoch[row.epoch],
                sample=final,
                **row.sampling(),
            )
        except Exception as exc:  # noqa: BLE001 — fail THIS request only
            self._drop_row(row)
            self._fail(row.req, exc)
            self._fail_all_in_flight(exc)
            return False
        row.prefilled = end
        self.prefill_tokens += end - start
        if final:
            if row.epoch == self._param_epoch:
                # Publish only CURRENT-epoch K/V: a row that straddled a
                # hot swap finished prefilling under superseded weights.
                engine.pool.register_prefix(row.table, row.req.prompt_ids)
            now = time.monotonic()
            row.req.first_token_t = now
            row.req.token_times.append(now)
            row.req.tokens.append(tok)
            self.tokens_generated += 1
        return True

    def _finish_or_activate(self, row: _Row) -> None:
        if self._is_finished(row):
            self._retire(row)
        else:
            self._active.append(row)

    def _shed_abandoned_in_flight(self) -> None:
        """Shed abandoned in-flight work (the waiter already got its
        timeout response) so the device never decodes for a gone client."""
        for rows in (self._active, self._prefilling):
            kept: list[_Row] = []
            for r in rows:
                if r.req.abandoned.is_set():
                    self._drop_row(r)
                    self._retire_abandoned(r.req)
                else:
                    kept.append(r)
            rows[:] = kept

    def _step_paged(self) -> bool:
        engine = self.engine
        chunk = engine.prefill_chunk
        # ---- join: admit while a slot AND a worst-case block budget exist.
        # Head-of-line order — admission is FIFO so a huge request cannot
        # be starved by a stream of small ones slipping past it.
        admitted = 0
        while len(self._active) + len(self._prefilling) < self.max_batch_slots:
            with self._lock:
                req = self._queue.popleft() if self._queue else None
            if req is None:
                break
            if req.abandoned.is_set():
                self._retire_abandoned(req)
                continue
            if (
                self._overload is not None
                and self._overload.shedding_active
                and self._overload.past_deadline(req)
            ):
                self._reject(req, REASON_DEADLINE_EXCEEDED, shed=True)
                continue
            if self._overload is not None:
                # Brownout clamp BEFORE validation/reservation: the
                # clamped budget is what the request decodes under.
                req.max_new_tokens = self._overload.clamp_new_tokens(
                    req.max_new_tokens
                )
            # A request this engine can NEVER serve fails ALONE instead of
            # wedging the FIFO head forever — try_reserve only says "not yet".
            reason = engine.validate_request(
                int(req.prompt_ids.shape[0]), int(req.max_new_tokens)
            )
            if reason is not None:
                self._fail(req, ValueError(reason))
                continue
            row = self._admit_paged(req)
            if row is None:
                # Pool full: back to its class head, retried next step.
                with self._lock:
                    self._queue.appendleft(req)
                break
            # Shared-prefix reuse: bind cached blocks read-only BEFORE any
            # grow; prefill then runs only the unmatched suffix. A partial
            # block match needs a private copy (COW) before its divergent
            # tail is written.
            match = engine.pool.match_prefix(req.prompt_ids)
            if match.hit:
                engine.pool.bind_prefix(row.table, match)
                row.prefilled = match.matched_tokens
                if match.partial_block is not None:
                    src, dst = engine.pool.cow_last_shared(row.table)
                    try:
                        engine.cow_copy(src, dst)
                    except Exception as exc:  # noqa: BLE001 — contain
                        self._drop_row(row)
                        self._fail(req, exc)
                        self._fail_all_in_flight(exc)
                        continue
            self._record_queue_wait(req)
            if chunk and (row.prompt_len - row.prefilled) > chunk:
                # Chunked prefill: the prompt streams in one chunk per
                # step (below), interleaved with decode.
                self._prefilling.append(row)
                admitted += 1
                continue
            if not self._prefill_next(row):
                continue
            self._finish_or_activate(row)
            admitted += 1

        self._shed_abandoned_in_flight()

        # ---- advance chunked prefills: ONE chunk per step, head-of-line,
        # so prompt streaming shares the device fairly with decode.
        chunked = False
        if self._prefilling:
            row = self._prefilling.pop(0)
            if self._prefill_next(row, limit=chunk):
                if row.prefilled == row.prompt_len:
                    self._finish_or_activate(row)
                else:
                    self._prefilling.insert(0, row)
            chunked = True

        # ---- advance every in-flight sequence one token, grouped by the
        # param epoch each row was ADMITTED under (hot-swap pinning).
        stepped = False
        if self._active:
            occupancy = len(self._active)
            self.peak_occupancy = max(self.peak_occupancy, occupancy)
            self._occupancy_samples += 1
            self._occupancy_total += occupancy
            by_epoch: dict[int, list[_Row]] = {}
            for r in self._active:
                by_epoch.setdefault(r.epoch, []).append(r)
            epochs = sorted(by_epoch)
            survivors: list[_Row] = []
            for gi, ep in enumerate(epochs):
                group = by_epoch[ep]
                rows = []
                for r in group:
                    # The fed token's absolute position; grow() binds its
                    # block within the admission-time reservation.
                    pos = r.prompt_len + len(r.req.tokens) - 1
                    engine.pool.grow(r.table, pos + 1)
                    rows.append(
                        {
                            "token": r.req.tokens[-1],
                            "position": pos,
                            "table": r.table.padded(engine.max_blocks_per_seq),
                            **r.sampling(),
                        }
                    )
                try:
                    toks = engine.decode(rows, params=self._params_by_epoch[ep])
                except Exception as exc:  # noqa: BLE001 — contain: a decode
                    # failure must not kill the scheduler thread (every
                    # later waiter would time out against a dead loop). The
                    # engine zeroed the pool, so every in-flight request
                    # fails loudly.
                    self._active = survivors + [
                        r for e2 in epochs[gi:] for r in by_epoch[e2]
                    ]
                    self._fail_all_in_flight(exc)
                    self._publish_metrics()
                    return True
                now = time.monotonic()
                for r, tok in zip(group, toks):
                    r.req.tokens.append(int(tok))
                    r.req.token_times.append(now)
                    self.tokens_generated += 1
                    if self._is_finished(r):
                        self._retire(r)
                    else:
                        survivors.append(r)
            self._active = survivors
            stepped = True

        self._publish_metrics()
        return stepped or chunked or admitted > 0

    # ------------------------------------------------------------ plumbing

    def _is_finished(self, row: _Row) -> bool:
        req = row.req
        if req.eos_token_id is not None and req.tokens[-1] == req.eos_token_id:
            req.finish_reason = "eos"
            return True
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _drop_row(self, row: _Row) -> None:
        """Return a row's pool resources + epoch pin (no req bookkeeping)."""
        self.engine.pool.release(row.table)
        self._unpin_epoch(row.epoch)

    def _retire(self, row: _Row) -> None:
        self._drop_row(row)
        row.req.finished_t = time.monotonic()
        self.requests_finished += 1
        if self.registry is not None:
            self.registry.inc("serve/requests")
        row.req.done.set()

    def _retire_abandoned(self, req: ServeRequest) -> None:
        logger.warning(
            "serve request %s abandoned by its waiter; shed", req.request_id
        )
        req.finish_reason = "abandoned"
        req.finished_t = time.monotonic()
        if self.registry is not None:
            self.registry.inc("serve/requests_abandoned")
        req.done.set()

    def _fail_all_in_flight(self, cause: Exception) -> None:
        for r in self._active + self._prefilling:
            self._drop_row(r)
            self._fail(
                r.req,
                RuntimeError(
                    f"in-flight KV lost to a failed engine step: {cause}"
                ),
            )
        self._active = []
        self._prefilling = []

    def _fail(self, req: ServeRequest, exc: Exception) -> None:
        logger.warning("serve request %s failed: %s", req.request_id, exc)
        req.error = str(exc)
        req.finish_reason = "error"
        req.finished_t = time.monotonic()
        if self.registry is not None:
            self.registry.inc("serve/request_errors")
        req.done.set()

    def _publish_metrics(self) -> None:
        if self.registry is None:
            return
        with self._lock:
            depth = len(self._queue)
        pool = self.engine.pool.stats()
        metrics = {
            "serve/queue_depth": float(depth),
            "serve/batch_occupancy": float(len(self._active)),
            "serve/peak_batch_occupancy": float(self.peak_occupancy),
            "serve/tokens_generated": float(self.tokens_generated),
            "serve/hot_swaps": float(self.hot_swaps),
            "serve/kv_pool_used_blocks": pool["allocated_blocks"],
            "serve/kv_pool_utilization": pool["utilization"],
            "serve/kv_pool_reserved_blocks": pool["reserved_blocks"],
        }
        if "prefix_hit_rate" in pool:
            metrics["serve/prefix_hits"] = pool["prefix_hits"]
            metrics["serve/prefix_hit_rate"] = pool["prefix_hit_rate"]
            metrics["serve/prefix_tokens_reused"] = pool["prefix_tokens_reused"]
        if self._overload is not None:
            # The SLO-facing overload gauges: predicted wait is what
            # admission decides on, brownout is the degraded-mode flag.
            metrics["serve/predicted_wait_ms"] = round(
                self._overload.predicted_wait_ms(depth), 3
            )
            metrics["serve/brownout"] = (
                1.0 if self._overload.in_brownout else 0.0
            )
        self.registry.publish(metrics)

    # ----------------------------------------------------------- lifecycle

    def stats(self) -> dict[str, Any]:
        with self._lock:
            depth = len(self._queue)
        mean_occ = (
            self._occupancy_total / self._occupancy_samples
            if self._occupancy_samples
            else 0.0
        )
        out: dict[str, Any] = {
            "policy": self.policy,
            "queue_depth": depth,
            "active_sequences": len(self._active),
            "prefilling_sequences": len(self._prefilling),
            "max_batch_slots": self.max_batch_slots,
            "requests_finished": self.requests_finished,
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "peak_batch_occupancy": self.peak_occupancy,
            "mean_batch_occupancy": round(mean_occ, 4),
        }
        meta = self._param_meta.get(self._param_epoch, {})
        out["params"] = {
            "epoch": self._param_epoch,
            "step": meta.get("step"),
            "checkpoint": meta.get("checkpoint"),
            "hot_swaps": self.hot_swaps,
            "live_epochs": sorted(self._params_by_epoch),
        }
        out["liveness"] = {
            "thread_alive": (
                self._thread.is_alive() if self._thread is not None else None
            ),
            "beacon_age_sec": round(time.monotonic() - self._beacon, 3),
        }
        if self._overload is not None:
            out["overload"] = self._overload.stats()
        out["kv_pool"] = self.engine.pool.stats()
        out["compile"] = self.engine.compile_stats()
        if self.engine.prefill_chunk:
            out["prefill_chunk"] = self.engine.prefill_chunk
        return out

    def alive(self, stale_sec: float = 30.0) -> bool:
        """Liveness truth for ``/healthz``: the loop thread is running and
        iterated within ``stale_sec``. A scheduler that was never
        ``start()``-ed (tests drive ``step()`` directly) counts alive."""
        if self._thread is None:
            return True
        if not self._thread.is_alive():
            return False
        return time.monotonic() - self._beacon <= float(stale_sec)

    def _idle(self) -> bool:
        return (
            not self._queue
            and not self._active
            and not self._prefilling
            and self._pending_swap is None
        )

    def run_forever(self, poll_sec: float = 0.005) -> None:
        """Scheduler loop body for the background thread."""
        while True:
            self._beacon = time.monotonic()
            with self._wake:
                idle = self._idle()
                if self._closed and idle:
                    return
                if idle:
                    self._wake.wait(timeout=poll_sec * 20)
            with self._lock:
                idle = self._idle()
            if self._closed and idle:
                return
            if not self.step():
                time.sleep(poll_sec)

    def start(self) -> "ContinuousBatchingScheduler":
        self._thread = threading.Thread(
            target=self.run_forever, name="serve-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Drain in-flight work, then stop the loop (bounded)."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning("serve scheduler did not drain in %.0fs", timeout)


__all__ = ["ContinuousBatchingScheduler", "ServeRequest"]
