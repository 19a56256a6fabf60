"""Distributed request tracing (the port's copy of
``llmtrain_tpu/telemetry/tracing.py``): W3C-style context, span buffers,
tail sampling.

The serving fleet is a router and N replicas (in-process or HTTP), each
process writing its own ``timeline.jsonl``. This module adds the
cross-process thread: a W3C-traceparent-style context (128-bit
``trace_id``, 64-bit ``span_id``, ``parent_span_id``) minted at the ingress
(router or HTTP handler), propagated over the replica hop as a
``traceparent`` header, and recorded alongside every timeline span a
request touches, so ``trace show`` (telemetry/trace_collect.py) can rebuild
one request's router→replica span tree from a directory of run dirs.

Overhead is bounded with **tail-based sampling**: every request carries a
small in-memory :class:`RequestTrace` span buffer, flushed to the timeline
— as ``cat="trace"`` events carrying the full ``trace_id``/``span_id``/
``parent_span_id`` tree — only when the request turns out to be
interesting: slow (top percentile of a latency reservoir), errored,
failed-over, or forced (``X-Trace: force``, which propagates across the
HTTP hop via the traceparent flags byte). Everything else keeps only the
un-treed timeline spans, which still carry a ``trace_id`` arg.

Clocks: buffered spans are stamped with ``time.perf_counter()`` — the
clock :class:`~.timeline.EventTimeline` uses — so flushed spans land at
their true time, not the flush time. Cross-process alignment uses the
timeline segment headers' ``start_unix_time`` (see trace_collect). Span
times are host times: a span that covers device work ends where the host
waited for it.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from .stats import percentile

__all__ = [
    "FORCE_HEADER",
    "TRACEPARENT_HEADER",
    "RequestTrace",
    "TailSampler",
    "TraceContext",
    "Tracer",
    "new_span_id",
    "new_trace_id",
]

TRACEPARENT_HEADER = "traceparent"
FORCE_HEADER = "X-Trace"

_HEX = set("0123456789abcdef")


def new_trace_id() -> str:
    """Globally unique 128-bit trace id (32 lowercase hex chars)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit span id (16 lowercase hex chars)."""
    return os.urandom(8).hex()


def _is_hex(s: str, n: int) -> bool:
    return len(s) == n and all(c in _HEX for c in s)


@dataclass
class TraceContext:
    """One position in a distributed trace: ``span_id`` is *this* hop's
    span, ``parent_span_id`` the remote/enclosing one. ``forced`` mirrors
    the traceparent sampled flag — a forced trace is kept on every process
    it touches, which is how ``X-Trace: force`` and failover retries get
    full fleet-wide detail."""

    trace_id: str
    span_id: str
    parent_span_id: str | None = None
    forced: bool = False

    @classmethod
    def root(cls, *, forced: bool = False) -> "TraceContext":
        return cls(new_trace_id(), new_span_id(), None, forced)

    def child(self) -> "TraceContext":
        """A new span under this one (same trace, forced flag inherited)."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id, self.forced)

    def to_traceparent(self) -> str:
        """``00-{trace_id}-{span_id}-{flags}`` — flags ``01`` propagates
        the forced/sampled decision to the receiving process."""
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.forced else '00'}"

    @classmethod
    def from_traceparent(cls, header: str | None) -> "TraceContext | None":
        """Parse a traceparent header; None on anything malformed (a bad
        header must never fail a request — it just loses its trace)."""
        if not header:
            return None
        parts = header.strip().lower().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        if version != "00" or not _is_hex(trace_id, 32) or not _is_hex(span_id, 16):
            return None
        if not _is_hex(flags, 2) or trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id, None, forced=bool(int(flags, 16) & 0x01))


@dataclass
class TraceSpan:
    name: str
    span_id: str
    parent_span_id: str | None
    t0: float  # perf_counter seconds
    t1: float
    args: dict[str, Any] = field(default_factory=dict)


class RequestTrace:
    """Per-request in-memory span buffer (the tail-sampling staging area).

    Threads append concurrently (router completion thread, scheduler step
    loop, HTTP handler); a small lock serializes. ``max_spans`` bounds a
    pathological request — overflow is counted, not grown.
    """

    __slots__ = (
        "ctx",
        "root_name",
        "spans",
        "events",
        "notes",
        "finished",
        "dropped",
        "_max_spans",
        "_lock",
    )

    def __init__(
        self, ctx: TraceContext, *, root_name: str = "serve/request", max_spans: int = 256
    ) -> None:
        self.ctx = ctx
        self.root_name = root_name
        self.spans: list[TraceSpan] = []
        self.events: list[TraceSpan] = []  # zero-duration (t0 == t1) marks
        self.notes: dict[str, Any] = {}
        self.finished = False
        self.dropped = 0
        self._max_spans = max_spans
        self._lock = threading.Lock()

    @property
    def trace_id(self) -> str:
        return self.ctx.trace_id

    @property
    def root_span_id(self) -> str:
        return self.ctx.span_id

    def force(self) -> None:
        self.ctx.forced = True

    def add_span(
        self,
        name: str,
        *,
        t0: float,
        t1: float,
        parent: str | None = None,
        span_id: str | None = None,
        **args: Any,
    ) -> str:
        """Buffer a finished span; returns its span id (pre-allocate via
        ``span_id=`` when the id must be sent over the wire BEFORE the
        span completes — the router's HTTP dispatch hop does this)."""
        sid = span_id or new_span_id()
        span = TraceSpan(name, sid, parent or self.ctx.span_id, t0, t1, args)
        with self._lock:
            if len(self.spans) < self._max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1
        return sid

    def add_event(
        self, name: str, *, t: float, parent: str | None = None, **args: Any
    ) -> None:
        """Buffer an instantaneous mark (prefix-cache hit, compile, shed
        verdict) — flushed as a zero-duration span under ``parent``."""
        ev = TraceSpan(name, new_span_id(), parent or self.ctx.span_id, t, t, args)
        with self._lock:
            if len(self.events) < self._max_spans:
                self.events.append(ev)
            else:
                self.dropped += 1

    def note(self, **kv: Any) -> None:
        """Attach root-span metadata (``failover=True``, ``error=...``);
        the ``failover`` note also upgrades the sampler verdict."""
        with self._lock:
            self.notes.update(kv)


class TailSampler:
    """Decides which finished traces are worth full-detail flushing.

    Keeps: forced (``X-Trace: force`` / propagated flags), errored,
    failed-over, warmup (the first ``warmup`` traces, so a fresh fleet has
    something to show), and slow — latency at or above the top
    ``slow_frac`` of a sliding reservoir of recent latencies. Everything
    else returns None (drop). Thread-safe; one instance per process.
    """

    def __init__(
        self,
        *,
        slow_frac: float = 0.05,
        reservoir: int = 512,
        warmup: int = 16,
    ) -> None:
        if not 0.0 < slow_frac <= 1.0:
            raise ValueError("slow_frac must be in (0, 1]")
        self._slow_frac = slow_frac
        self._reservoir_len = max(16, reservoir)
        self._warmup = warmup
        self._reservoir: list[float] = []
        self._idx = 0
        self._seen = 0
        self._lock = threading.Lock()

    def decide(
        self,
        latency_ms: float,
        *,
        errored: bool = False,
        failover: bool = False,
        forced: bool = False,
    ) -> str | None:
        with self._lock:
            seen = self._seen
            self._seen += 1
            res = self._reservoir
            threshold: float | None = None
            if res and len(res) >= self._warmup:
                threshold = percentile(sorted(res), 1.0 - self._slow_frac)
            # Sliding reservoir: overwrite in ring order once full.
            if len(res) < self._reservoir_len:
                res.append(latency_ms)
            else:
                res[self._idx] = latency_ms
                self._idx = (self._idx + 1) % self._reservoir_len
        if forced:
            return "forced"
        if errored:
            return "error"
        if failover:
            return "failover"
        if seen < self._warmup:
            return "warmup"
        if threshold is not None and latency_ms >= threshold:
            return "slow"
        return None


class Tracer:
    """Binds an :class:`EventTimeline` to a :class:`TailSampler`.

    ``start`` mints a request's context; ``finish`` is called exactly once
    per request by whichever component resolves it (scheduler retire/fail/
    reject, router HTTP-completion) — it asks the sampler, and on keep
    flushes the buffered tree into the timeline as ``cat="trace"`` events
    that the collector (trace_collect.py) reassembles fleet-wide.
    """

    def __init__(
        self,
        timeline: "EventTimeline",
        *,
        sampler: TailSampler | None = None,
        max_spans: int = 256,
    ) -> None:
        self.timeline = timeline
        self.sampler = sampler or TailSampler()
        self._max_spans = max_spans
        self._lock = threading.Lock()
        self.kept: dict[str, int] = {}
        self.finished = 0

    def start(
        self,
        *,
        parent: TraceContext | None = None,
        root_name: str = "serve/request",
        forced: bool = False,
    ) -> RequestTrace:
        """New request trace: a fresh root, or a child hop of a remote
        ``parent`` parsed from a traceparent header."""
        if parent is not None:
            ctx = parent.child()
            if forced:
                ctx.forced = True
        else:
            ctx = TraceContext.root(forced=forced)
        return RequestTrace(ctx, root_name=root_name, max_spans=self._max_spans)

    def finish(
        self,
        trace: RequestTrace | None,
        *,
        t0: float,
        t1: float | None = None,
        errored: bool = False,
        failover: bool = False,
        **root_args: Any,
    ) -> str | None:
        """Resolve a request's trace; returns the keep-reason or None.

        Idempotent — the first caller wins (router and scheduler can both
        sit on a request's completion path). ``t0``/``t1`` are
        perf_counter stamps bounding the root span (submit → done).
        """
        if trace is None:
            return None
        with trace._lock:
            if trace.finished:
                return None
            trace.finished = True
            notes = dict(trace.notes)
            spans = list(trace.spans)
            events = list(trace.events)
        if t1 is None:
            t1 = time.perf_counter()
        reason = self.sampler.decide(
            (t1 - t0) * 1000.0,
            errored=errored or bool(notes.get("error")),
            failover=failover or bool(notes.get("failover")),
            forced=trace.ctx.forced,
        )
        with self._lock:
            self.finished += 1
            if reason is not None:
                self.kept[reason] = self.kept.get(reason, 0) + 1
        if reason is None:
            return None
        tl = self.timeline
        ctx = trace.ctx
        root: dict[str, Any] = {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "sampled": reason,
        }
        if ctx.parent_span_id:
            root["parent_span_id"] = ctx.parent_span_id
        if trace.dropped:
            root["dropped_spans"] = trace.dropped
        root.update(notes)
        root.update(root_args)
        tl.record(trace.root_name, t0=t0, t1=t1, cat="trace", **root)
        for s in spans + events:
            # Span args may legitimately carry a correlation trace_id
            # already (the live-span copy does); the tree ids win.
            merged = dict(s.args)
            merged.update(
                trace_id=ctx.trace_id,
                span_id=s.span_id,
                parent_span_id=s.parent_span_id,
            )
            tl.record(s.name, t0=s.t0, t1=s.t1, cat="trace", **merged)
        # Duck-typed timelines (tests, adapters) only promise the
        # instant/record/span surface — flush is an EventTimeline extra.
        flush = getattr(tl, "flush", None)
        if flush is not None:
            flush()
        return reason

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"finished": self.finished, "kept": dict(self.kept)}
