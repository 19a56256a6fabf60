"""HTTP surface of the inference server (port of
``llmtrain_tpu/serving/http.py``; stdlib only).

* ``GET /healthz`` — liveness + model/checkpoint metadata and request
  stats, with the scheduler, KV-pool and shape stats when the
  continuous-batching backend is attached; 503 when its loop is dead or
  its beacon is stale.
* ``GET /metrics`` — Prometheus exposition of the serving registry
  (``llmtrain_serve_*``): the scheduler's gauges, counters, latency
  percentiles from the :class:`ServerStats` reservoir, and histograms.
* ``POST /v1/generate`` — validate, then either SUBMIT to the continuous
  batch and wait on the request's completion (N handler threads → N
  in-flight sequences; 429 with the reason and ``Retry-After`` when
  overload control says no; 503 and abandonment on timeout; 500 for a
  failed request while the scheduler keeps running), or, in simple mode,
  one ``generate()`` call behind the device lock with a
  ``torch.Generator`` seeded from the request's ``seed``.
* ``POST /reload`` — zero-downtime checkpoint hot swap through the CLI's
  reloader (continuous mode); 404 without one.

As in the JAX server, a request whose prompt + ``max_new_tokens`` exceeds
``block_size`` is answered with 400, so a served request always takes the
KV-cache branch of ``generate()``; the sliding-window re-forward branch,
which runs the flash kernel, is reached through ``generate()`` itself and
the ``generate`` CLI. Request tracing is not yet ported (ROADMAP.md queue
A: telemetry).

Thread discipline: ``ThreadingHTTPServer`` runs one handler thread per
connection, so every cross-request mutable lives in :class:`ServerStats`
behind its own lock.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from ..telemetry.stats import percentile as _nearest_rank_percentile

_TTFT_BUCKETS_MS = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)
_LATENCY_BUCKETS_MS = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    10000.0, 30000.0,
)
_PER_TOKEN_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0)


class ServerStats:
    """Lock-protected cross-request counters/accumulators."""

    _RESERVOIR = 512  # newest samples kept for percentile estimation
    _QUANTILES = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._tokens_out = 0
        self._latency_sum_ms = 0.0
        self._latencies_ms: list[float] = []
        self._ttft_ms: list[float] = []
        self._per_token_ms: list[float] = []

    @staticmethod
    def _push(reservoir: list[float], value: float) -> None:
        reservoir.append(value)
        if len(reservoir) > ServerStats._RESERVOIR:
            del reservoir[: -ServerStats._RESERVOIR]

    def record(
        self, *, latency_ms: float, tokens: int, ttft_ms: float | None = None
    ) -> None:
        with self._lock:
            self._requests += 1
            self._tokens_out += tokens
            self._latency_sum_ms += latency_ms
            self._push(self._latencies_ms, latency_ms)
            if ttft_ms is not None:
                self._push(self._ttft_ms, ttft_ms)
                # Per-token decode latency: time AFTER the first token over
                # the remaining tokens, not diluted by prefill.
                if tokens > 1:
                    self._push(
                        self._per_token_ms, (latency_ms - ttft_ms) / (tokens - 1)
                    )
            elif tokens > 0:
                self._push(self._per_token_ms, latency_ms / tokens)

    def record_error(self) -> None:
        with self._lock:
            self._errors += 1

    @property
    def requests_served(self) -> int:
        with self._lock:
            return self._requests

    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float | None:
        if not sorted_vals:
            return None
        return _nearest_rank_percentile(sorted_vals, q)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            n = self._requests
            lat = sorted(self._latencies_ms)
            ttft = sorted(self._ttft_ms)
            return {
                "requests_served": n,
                "errors": self._errors,
                "tokens_out": self._tokens_out,
                "mean_latency_ms": round(self._latency_sum_ms / n, 3) if n else None,
                "p50_latency_ms": round(lat[len(lat) // 2], 3) if lat else None,
                "p95_latency_ms": (
                    round(self._percentile(lat, 0.95), 3) if lat else None
                ),
                # Simple mode decodes a request in one call: only the
                # continuous backend observes a time to first token.
                "p50_ttft_ms": round(ttft[len(ttft) // 2], 3) if ttft else None,
            }

    def prometheus_gauges(self) -> dict[str, float]:
        """p50/p95/p99 gauges merged into GET /metrics on every scrape;
        empty reservoirs export nothing."""
        with self._lock:
            series = {
                "serve/latency_ms": sorted(self._latencies_ms),
                "serve/ttft_ms": sorted(self._ttft_ms),
                "serve/per_token_ms": sorted(self._per_token_ms),
            }
        gauges: dict[str, float] = {}
        for stem, vals in series.items():
            for q, tag in self._QUANTILES:
                value = self._percentile(vals, q)
                if value is not None:
                    gauges[f"{stem}_{tag}"] = value
        return gauges


@dataclass
class ServerState:
    """Everything a request needs; built once by the CLI before serving."""

    model: Any
    tokenizer: Any | None
    step: int
    checkpoint: str
    eos_token_id: int | None = None
    max_new_tokens_cap: int = 256
    default_max_new_tokens: int = 48
    # Simple mode only — one decode at a time behind the device lock. The
    # continuous backend replaces the lock with its admission queue.
    lock: threading.Lock = field(default_factory=threading.Lock)
    stats: ServerStats = field(default_factory=ServerStats)
    # Continuous-batching backend (serving/scheduler.py); None = simple.
    scheduler: Any | None = None
    # Telemetry registry served on GET /metrics (llmtrain_serve_*).
    registry: Any | None = None
    request_timeout_sec: float = 120.0
    # POST /reload calls this with the request body; it loads the
    # checkpoint, hot-swaps the scheduler and returns the response dict
    # (the CLI builds the closure). None = 404.
    reloader: Any | None = None
    # /healthz turns 503 when the scheduler loop's beacon is older than
    # this (serving.liveness_stale_sec).
    liveness_stale_sec: float = 30.0
    # Per-client token buckets at the HTTP boundary (overload.ClientRateGate,
    # keyed by X-Client-Id). None = no per-client rate limiting.
    client_gate: Any | None = None

    @property
    def requests_served(self) -> int:
        return self.stats.requests_served

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _bad_request(msg: str) -> tuple[int, dict]:
    return 400, {"error": msg}


def _header(headers: Any, name: str) -> str | None:
    """Header lookup (``email.message.Message.get`` ignores case)."""
    return None if headers is None else headers.get(name)


def _handle_generate_request(
    state: ServerState, body: dict, headers: Any = None
) -> tuple[int, dict]:
    """Pure request logic (no HTTP): validate -> decode -> respond. An
    ``X-Request-Id`` header echoes on every response."""
    code, payload = _generate_request_inner(state, body, headers)
    rid = _header(headers, "X-Request-Id")
    if rid and isinstance(payload, dict) and "request_id" not in payload:
        payload["request_id"] = rid
    return code, payload


def _generate_request_inner(
    state: ServerState, body: dict, headers: Any = None
) -> tuple[int, dict]:
    from ..generation import generate

    if not isinstance(body, dict):
        return _bad_request("request body must be a JSON object")
    rid = _header(headers, "X-Request-Id")
    echo: dict[str, Any] = {"request_id": rid} if rid else {}
    deadline_ms: float | None = None
    raw_deadline = _header(headers, "X-Deadline-Ms")
    if raw_deadline is not None:
        try:
            deadline_ms = float(raw_deadline)
        except (TypeError, ValueError):
            deadline_ms = -1.0
        if deadline_ms <= 0:
            return 400, {"error": "X-Deadline-Ms must be a positive number", **echo}
    priority = _header(headers, "X-Priority") or "interactive"

    if state.client_gate is not None:
        client = _header(headers, "X-Client-Id") or "_anon"
        wait = state.client_gate.check(client)
        if wait is not None:
            if state.registry is not None:
                from .overload import REASON_RATE_LIMITED, rejected_counter

                state.registry.inc(rejected_counter(REASON_RATE_LIMITED))
            return 429, {
                "error": f"client {client!r} is over its request rate",
                "reason": "rate_limited",
                "retry_after": round(wait, 3),
                **echo,
            }
    unknown = set(body) - {
        "prompt", "prompt_ids", "max_new_tokens", "temperature",
        "top_k", "top_p", "seed", "eos_token_id",
    }
    if unknown:
        return _bad_request(f"unknown fields: {sorted(unknown)}")
    if ("prompt" in body) == ("prompt_ids" in body):
        return _bad_request("provide exactly one of 'prompt' or 'prompt_ids'")

    vocab = int(getattr(state.model, "vocab_size", 0) or 0)
    if "prompt" in body:
        if state.tokenizer is None:
            return _bad_request("this server has no tokenizer; send 'prompt_ids' instead")
        if not isinstance(body["prompt"], str) or not body["prompt"]:
            return _bad_request("'prompt' must be a non-empty string")
        ids = np.asarray(state.tokenizer.encode(body["prompt"]), dtype=np.int32)
    else:
        raw = body["prompt_ids"]
        if not isinstance(raw, list) or not raw or not all(isinstance(t, int) for t in raw):
            return _bad_request("'prompt_ids' must be a non-empty list of ints")
        bound = vocab or 2**31 - 1  # int32 dtype bound when vocab unknown
        if not all(0 <= t < bound for t in raw):
            return _bad_request(f"prompt token ids must be in [0, {bound})")
        ids = np.asarray(raw, dtype=np.int32)
    if ids.size == 0:
        return _bad_request("prompt encodes to zero tokens")

    # A server started with a cap below the default must still accept
    # knob-less requests: the effective default is min(default, cap).
    max_new = body.get(
        "max_new_tokens", min(state.default_max_new_tokens, state.max_new_tokens_cap)
    )
    if not isinstance(max_new, int) or max_new < 1:
        return _bad_request("'max_new_tokens' must be a positive int")
    if max_new > state.max_new_tokens_cap:
        return _bad_request(
            f"'max_new_tokens' exceeds the server cap ({state.max_new_tokens_cap})"
        )
    block_size = int(state.model.block_size)
    if ids.size + max_new > block_size:
        return _bad_request(
            f"prompt ({ids.size}) + max_new_tokens ({max_new}) exceeds the "
            f"model block_size ({block_size})"
        )
    engine = getattr(state.scheduler, "engine", None)
    if engine is not None:
        # Paged-backend bounds (prompt bucket, pool capacity): reject at
        # the HTTP boundary as a 400, not a late 500 from inside prefill.
        reason = engine.validate_request(int(ids.size), int(max_new))
        if reason is not None:
            return _bad_request(reason)
    temperature = body.get("temperature", 1.0)
    if not isinstance(temperature, (int, float)) or isinstance(temperature, bool):
        return _bad_request("'temperature' must be a number")
    if temperature < 0:
        return _bad_request("'temperature' must be >= 0")
    top_k = body.get("top_k")
    if top_k is not None and (not isinstance(top_k, int) or isinstance(top_k, bool)):
        return _bad_request("'top_k' must be an int")
    top_p = body.get("top_p")
    if top_p is not None and (not isinstance(top_p, (int, float)) or isinstance(top_p, bool)):
        return _bad_request("'top_p' must be a number")
    seed = body.get("seed", 0)
    if not isinstance(seed, int) or isinstance(seed, bool):
        return _bad_request("'seed' must be an int")
    eos = body.get("eos_token_id", state.eos_token_id)
    if eos is not None and (not isinstance(eos, int) or isinstance(eos, bool)):
        return _bad_request("'eos_token_id' must be an int")

    t0 = time.monotonic()
    extra: dict[str, Any] = {}
    if state.scheduler is not None:
        # Continuous batching: enqueue and wait; the scheduler thread
        # joins this sequence into the in-flight batch.
        from .scheduler import ServeRequest

        req = ServeRequest(
            prompt_ids=ids,
            max_new_tokens=max_new,
            temperature=float(temperature),
            top_k=top_k,
            top_p=top_p,
            seed=seed,
            eos_token_id=eos,
            deadline_ms=deadline_ms,
            priority=priority,
            rid=rid,
        )
        state.scheduler.submit(req)
        if not req.done.wait(timeout=state.request_timeout_sec):
            # Tell the scheduler this waiter is gone, so the device does
            # not keep decoding for nobody.
            req.abandon()
            state.stats.record_error()
            return 503, {"error": "request timed out in the serving queue", **echo}
        if req.finish_reason in ("rejected", "shed"):
            # Overload control said no — fast 429 with the reason and a
            # Retry-After hint (do_POST lifts it into the header).
            payload: dict[str, Any] = {
                "error": f"request {req.finish_reason} by overload control",
                "reason": req.reject_reason,
                "finish_reason": req.finish_reason,
                **echo,
            }
            if req.retry_after_sec is not None:
                payload["retry_after"] = round(req.retry_after_sec, 3)
            return 429, payload
        if req.error is not None:
            state.stats.record_error()
            return 500, {"error": f"generation failed: {req.error}", **echo}
        completion = list(req.tokens)
        if req.ttft_ms is not None:
            extra["ttft_ms"] = round(req.ttft_ms, 3)
        extra["finish_reason"] = req.finish_reason
    else:
        with state.lock:
            generator = torch.Generator(device=state.device)
            generator.manual_seed(seed)
            out = generate(
                state.model,
                ids[None, :],
                max_new_tokens=max_new,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                eos_token_id=eos,
                generator=generator,
            )
        completion = [int(t) for t in out[0, ids.size :]]
        if eos is not None and eos in completion:
            completion = completion[: completion.index(eos) + 1]
    latency_ms = (time.monotonic() - t0) * 1000.0
    ttft_ms = extra.get("ttft_ms")
    state.stats.record(latency_ms=latency_ms, tokens=len(completion), ttft_ms=ttft_ms)
    if state.registry is not None:
        _observe_histograms(state.registry, latency_ms, len(completion), ttft_ms)
        if state.scheduler is None:
            # The scheduler counts its own requests.
            state.registry.inc("serve/requests")

    text = None
    if state.tokenizer is not None:
        try:
            text = state.tokenizer.decode(completion)
        except Exception:  # noqa: BLE001 — decode is best-effort for ids
            text = None
    return 200, {
        "completion_ids": completion,
        "text": text,
        "prompt_tokens": int(ids.size),
        "latency_ms": round(latency_ms, 3),
        **extra,
        **echo,
    }


def _observe_histograms(
    registry: Any, latency_ms: float, tokens: int, ttft_ms: float | None
) -> None:
    """Feed the /metrics histograms (latency; TTFT and per-token decode
    latency where the backend measured a first token)."""
    registry.observe("serve/latency_ms", latency_ms, buckets=_LATENCY_BUCKETS_MS)
    if ttft_ms is not None:
        registry.observe("serve/ttft_ms", ttft_ms, buckets=_TTFT_BUCKETS_MS)
        if tokens > 1:
            registry.observe("serve/per_token_ms", (latency_ms - ttft_ms) / (tokens - 1),
                             buckets=_PER_TOKEN_BUCKETS_MS)


def _handle_reload(state: ServerState, body: Any) -> tuple[int, dict]:
    """POST /reload — zero-downtime checkpoint hot swap. The heavy work
    (checkpoint resolve, param load, scheduler.hot_swap) lives in the CLI's
    reloader closure; in-flight requests keep decoding on their admitted
    weights throughout."""
    if state.reloader is None:
        return 404, {"error": "this server has no reloader attached"}
    if body is None:
        body = {}
    if not isinstance(body, dict):
        return _bad_request("request body must be a JSON object (or empty)")
    try:
        out = state.reloader(body)
    except Exception as exc:  # noqa: BLE001 — a bad checkpoint must not 500
        # the serving loop: the old weights keep serving.
        return 409, {"error": f"reload failed (still serving old params): {exc}"}
    return 200, {"status": "ok", **(out or {})}


def _handle_health(state: ServerState) -> tuple[int, dict]:
    """Liveness + stats: a dead or wedged scheduler loop answers 503."""
    payload: dict[str, Any] = {
        "status": "ok",
        "model": type(state.model).__name__,
        "step": state.step,
        "checkpoint": state.checkpoint,
        "requests_served": state.stats.requests_served,
        "stats": state.stats.snapshot(),
    }
    if state.scheduler is not None:
        payload["scheduler"] = state.scheduler.stats()
        if not state.scheduler.alive(state.liveness_stale_sec):
            payload["status"] = "unhealthy"
            return 503, payload
    return 200, payload


def _handle_metrics(state: ServerState) -> tuple[int, str]:
    """Prometheus text for GET /metrics (requires a registry)."""
    if state.registry is None:
        return 404, "no metrics registry attached\n"
    from ..telemetry.prometheus import render_prometheus

    gauges = dict(state.registry.latest())
    # Live SLO percentiles from the stats reservoir, computed at scrape time.
    for name, value in state.stats.prometheus_gauges().items():
        gauges[name] = (value, None)
    return 200, render_prometheus(
        gauges,
        state.registry.counters(),
        {"component": "serve", "checkpoint": state.checkpoint},
        histograms=state.registry.histograms(),
    )


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server().
    state: ServerState = None  # type: ignore[assignment]

    def _respond(
        self, code: int, payload: dict, headers: dict[str, str] | None = None
    ) -> None:
        data = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    @staticmethod
    def _slo_headers(code: int, payload: dict) -> dict[str, str]:
        """429/503 carry Retry-After (integer seconds, >= 1 per RFC 9110),
        and X-Request-Id echoes back whenever the request carried one."""
        out: dict[str, str] = {}
        retry_after = payload.get("retry_after") if isinstance(payload, dict) else None
        if code in (429, 503) and isinstance(retry_after, (int, float)):
            out["Retry-After"] = str(max(1, int(-(-float(retry_after) // 1))))
        rid = payload.get("request_id") if isinstance(payload, dict) else None
        if rid:
            out["X-Request-Id"] = str(rid)
        return out

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            code, payload = _handle_health(self.state)
            headers = {}
            if code == 503:
                headers["Retry-After"] = str(max(1, int(self.state.liveness_stale_sec)))
            self._respond(code, payload, headers)
        elif self.path.split("?")[0] == "/metrics":
            code, text = _handle_metrics(self.state)
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._respond(404, {"error": f"no route for GET {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path not in ("/v1/generate", "/reload"):
            self._respond(404, {"error": f"no route for POST {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"null")
        except (ValueError, json.JSONDecodeError):
            self._respond(400, {"error": "body is not valid JSON"})
            return
        if self.path == "/reload":
            self._respond(*_handle_reload(self.state, body))
            return
        try:
            code, payload = _handle_generate_request(self.state, body, self.headers)
            self._respond(code, payload, self._slo_headers(code, payload))
        except Exception as exc:  # noqa: BLE001 — server must not die
            self.state.stats.record_error()
            self._respond(500, {"error": f"generation failed: {exc}"})

    def log_message(self, fmt: str, *args: Any) -> None:
        from ..utils.logging import get_logger

        get_logger().info("serve: %s", fmt % args)


def make_server(
    state: ServerState, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral; read ``server_address[1]``), don't serve."""
    handler = type("BoundHandler", (_Handler,), {"state": state})
    return ThreadingHTTPServer((host, port), handler)


__all__ = ["ServerState", "ServerStats", "make_server"]
