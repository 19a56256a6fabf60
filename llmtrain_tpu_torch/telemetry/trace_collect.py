"""Fleet-wide trace collection (the port's copy of
``llmtrain_tpu/telemetry/trace_collect.py``): merge per-process timelines,
build trees.

Every process in a serving fleet — the router and its HTTP replicas —
writes its own ``timeline.jsonl`` (telemetry/timeline.py). Sampled request
traces land in those files as ``cat="trace"`` events whose args carry the
full ``trace_id``/``span_id``/``parent_span_id`` tree
(telemetry/tracing.py). This module is the read side:

* :func:`discover_sources` / :func:`load_source` — find and parse the
  JSONL files under one or more run dirs, mapping each event's
  process-relative ``ts_us`` to absolute unix time via the segment
  headers' ``start_unix_time`` anchor.
* :func:`collect_traces` — group trace events by ``trace_id`` into
  :class:`Trace` span trees; parentage works across sources because the
  router pre-allocates its HTTP-hop span id and ships it in the
  ``traceparent`` header.
* :func:`critical_path` — exclusive-time tiling of one trace: every
  millisecond of the root span is attributed to exactly one span name, so
  the breakdown sums to the end-to-end latency by construction.
* :func:`summarize` / :func:`slowest` — per-span-kind nearest-rank
  percentiles and the top-k slowest traces for the ``trace`` CLI.
* :func:`merge_perfetto` — one Chrome/Perfetto trace with a track group
  per process and flow arrows (``zlib.crc32`` ids, as JAX's) linking
  parent→child spans across processes.

The file format is JAX's, so either package reads the other's run dirs.
Everything here is offline post-processing over files.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Sequence

from .stats import percentiles

__all__ = [
    "Span",
    "Trace",
    "TraceSource",
    "collect_traces",
    "critical_path",
    "discover_sources",
    "format_tree",
    "load_source",
    "merge_perfetto",
    "slowest",
    "summarize",
]


@dataclass
class Span:
    """One node of a trace tree, in absolute unix seconds."""

    name: str
    span_id: str
    parent_span_id: str | None
    t0: float
    t1: float
    source: str  # which process/file recorded it
    args: dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0


@dataclass
class TraceSource:
    """One parsed timeline file: events with absolute timestamps."""

    path: Path
    label: str
    events: list[dict[str, Any]] = field(default_factory=list)
    # Wall-clock anchor of the file's FIRST segment (None when the file
    # has no segment header — then events keep their relative stamps).
    start_unix_time: float | None = None


class Trace:
    """All spans of one ``trace_id``, assembled into a forest.

    A fully-sampled request has one root (the router's or scheduler's
    ``*/request`` span); when only some processes kept the trace, the
    orphaned subtrees surface as extra roots rather than being dropped.
    """

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self._by_id: dict[str, Span] = {}

    def add(self, span: Span) -> None:
        # A span id can legitimately appear twice (the router records its
        # hop span; a replica's root CLAIMS that id as parent, not as its
        # own) — but identical ids mean a re-flushed line; first wins.
        if span.span_id in self._by_id:
            return
        self._by_id[span.span_id] = span
        self.spans.append(span)

    def get(self, span_id: str) -> Span | None:
        return self._by_id.get(span_id)

    def children(self, span_id: str) -> list[Span]:
        out = [s for s in self.spans if s.parent_span_id == span_id]
        out.sort(key=lambda s: (s.t0, s.t1))
        return out

    @property
    def roots(self) -> list[Span]:
        out = [
            s
            for s in self.spans
            if not s.parent_span_id or s.parent_span_id not in self._by_id
        ]
        out.sort(key=lambda s: (s.t0, s.t1))
        return out

    @property
    def root(self) -> Span | None:
        """The primary root: earliest-starting, longest span among the
        forest roots (the router/ingress request span when present)."""
        roots = self.roots
        if not roots:
            return None
        return max(roots, key=lambda s: s.t1 - s.t0)

    @property
    def duration_ms(self) -> float:
        root = self.root
        return root.duration_ms if root is not None else 0.0

    @property
    def sources(self) -> list[str]:
        seen: list[str] = []
        for s in self.spans:
            if s.source not in seen:
                seen.append(s.source)
        return seen


# ---------------------------------------------------------------- loading


def _source_label(path: Path) -> str:
    """Human label for a timeline file: the owning run/replica dir name
    plus the file stem (``replica0/timeline``, ``run/promote_timeline``)."""
    parent = path.parent
    if parent.name == "telemetry" and parent.parent.name:
        return f"{parent.parent.name}/{path.stem}"
    return f"{parent.name}/{path.stem}" if parent.name else path.stem


def load_source(path: str | Path, label: str | None = None) -> TraceSource:
    """Parse one timeline JSONL. Events gain ``_abs_ts`` (absolute unix
    seconds) from the most recent segment header's ``start_unix_time``;
    files with no header keep relative seconds (still self-consistent).
    Malformed lines are skipped — a live fleet may be mid-write."""
    p = Path(path)
    src = TraceSource(path=p, label=label or _source_label(p))
    anchor: float | None = None
    try:
        text = p.read_text(encoding="utf-8")
    except OSError:
        return src
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(ev, dict):
            continue
        if ev.get("ph") == "seg":
            start = ev.get("start_unix_time")
            if isinstance(start, (int, float)):
                anchor = float(start)
                if src.start_unix_time is None:
                    src.start_unix_time = anchor
            continue
        ts_us = ev.get("ts_us")
        if not isinstance(ts_us, (int, float)):
            continue
        ev["_abs_ts"] = (anchor or 0.0) + float(ts_us) / 1e6
        ev["_source"] = src.label
        src.events.append(ev)
    return src


def discover_sources(
    run_dirs: Sequence[str | Path],
) -> list[TraceSource]:
    """Find every ``*timeline*.jsonl`` under the given dirs (a file path
    is accepted directly) and load them. Duplicate labels get a numeric
    suffix so Perfetto track groups stay distinct."""
    paths: list[Path] = []
    for d in run_dirs:
        p = Path(d)
        if p.is_file():
            paths.append(p)
        elif p.is_dir():
            paths.extend(sorted(p.rglob("*timeline*.jsonl")))
    sources: list[TraceSource] = []
    seen_labels: dict[str, int] = {}
    for path in paths:
        src = load_source(path)
        n = seen_labels.get(src.label, 0)
        seen_labels[src.label] = n + 1
        if n:
            src.label = f"{src.label}#{n}"
            for ev in src.events:
                ev["_source"] = src.label
        sources.append(src)
    return sources


# -------------------------------------------------------------- assembly


def collect_traces(
    sources: Iterable[TraceSource],
) -> dict[str, Trace]:
    """Group every ``cat="trace"`` event across all sources into
    :class:`Trace` trees keyed by trace id."""
    traces: dict[str, Trace] = {}
    for src in sources:
        for ev in src.events:
            if ev.get("cat") != "trace":
                continue
            args = ev.get("args") or {}
            trace_id = args.get("trace_id")
            span_id = args.get("span_id")
            if not trace_id or not span_id:
                continue
            t0 = float(ev["_abs_ts"])
            t1 = t0 + float(ev.get("dur_us", 0)) / 1e6
            extra = {
                k: v
                for k, v in args.items()
                if k not in ("trace_id", "span_id", "parent_span_id")
            }
            trace = traces.setdefault(trace_id, Trace(trace_id))
            trace.add(
                Span(
                    name=str(ev.get("name", "?")),
                    span_id=str(span_id),
                    parent_span_id=args.get("parent_span_id") or None,
                    t0=t0,
                    t1=t1,
                    source=str(ev.get("_source", "?")),
                    args=extra,
                )
            )
    return traces


def slowest(traces: dict[str, Trace], k: int = 10) -> list[Trace]:
    """Top-k traces by root duration (the tail the sampler kept)."""
    ranked = sorted(
        traces.values(), key=lambda t: t.duration_ms, reverse=True
    )
    return ranked[: max(0, int(k))]


# -------------------------------------------------------- critical path


def critical_path(trace: Trace) -> dict[str, Any]:
    """Exclusive-time breakdown of one trace.

    Tiling: walk the tree from the primary root; each child's window
    (clipped to its parent and to what earlier siblings already claimed)
    is handed to the child's subtree, and every gap stays with the
    parent. Every instant of the root interval is attributed exactly
    once, so ``sum(breakdown) == end-to-end`` by construction — the
    property that makes "queue_wait was 80% of this request" a statement
    about the actual latency, not about overlapping span sums.
    """
    root = trace.root
    if root is None:
        return {"trace_id": trace.trace_id, "total_ms": 0.0, "breakdown": {}}
    breakdown: dict[str, float] = {}

    def walk(span: Span, lo: float, hi: float) -> None:
        lo, hi = max(lo, span.t0), min(hi, span.t1)
        if hi <= lo:
            return
        cursor = lo
        for child in trace.children(span.span_id):
            if child.t1 <= child.t0:  # zero-duration marks don't tile
                continue
            c0, c1 = max(child.t0, cursor), min(child.t1, hi)
            if c1 <= c0:
                continue
            if c0 > cursor:
                breakdown[span.name] = (
                    breakdown.get(span.name, 0.0) + (c0 - cursor)
                )
            walk(child, c0, c1)
            cursor = c1
        if hi > cursor:
            breakdown[span.name] = breakdown.get(span.name, 0.0) + (hi - cursor)

    walk(root, root.t0, root.t1)
    total_ms = root.duration_ms
    out = {
        name: round(sec * 1000.0, 3)
        for name, sec in sorted(
            breakdown.items(), key=lambda kv: kv[1], reverse=True
        )
    }
    return {
        "trace_id": trace.trace_id,
        "root": root.name,
        "total_ms": round(total_ms, 3),
        "breakdown": out,
        "sources": trace.sources,
        "spans": len(trace.spans),
    }


def summarize(traces: dict[str, Trace]) -> dict[str, Any]:
    """Per-span-kind latency percentiles across every collected trace —
    the fleet-wide answer to "where does tail time go"."""
    by_name: dict[str, list[float]] = {}
    root_ms: list[float] = []
    for trace in traces.values():
        if trace.root is not None:
            root_ms.append(trace.duration_ms)
        for span in trace.spans:
            if span.t1 > span.t0:
                by_name.setdefault(span.name, []).append(span.duration_ms)
    spans = {
        name: {"count": len(vals), **percentiles(vals)}
        for name, vals in sorted(by_name.items())
    }
    return {
        "traces": len(traces),
        "end_to_end_ms": percentiles(root_ms),
        "spans": spans,
    }


# ------------------------------------------------------------- rendering


def format_tree(trace: Trace) -> list[str]:
    """ASCII span tree of one trace (``llmtrain trace show``): offsets
    are milliseconds from the root start, one line per span, children
    indented under their parents, cross-process hops labeled."""
    root = trace.root
    lines = [f"trace {trace.trace_id}  ({trace.duration_ms:.1f} ms, "
             f"{len(trace.spans)} spans, {len(trace.sources)} processes)"]
    if root is None:
        return lines
    base = root.t0
    seen: set[str] = set()

    def emit(span: Span, depth: int) -> None:
        if span.span_id in seen:  # defensive: a cycle must not hang the CLI
            return
        seen.add(span.span_id)
        off = (span.t0 - base) * 1000.0
        pad = "  " * depth
        note = ""
        if span.args.get("error"):
            note = f"  error={span.args['error']}"
        elif span.args.get("sampled"):
            note = f"  [{span.args['sampled']}]"
        lines.append(
            f"{pad}{span.name}  +{off:.1f}ms  {span.duration_ms:.1f}ms"
            f"  ({span.source}){note}"
        )
        for child in trace.children(span.span_id):
            emit(child, depth + 1)

    for r in trace.roots:
        emit(r, 0)
    return lines


# ---------------------------------------------------------------- merge


def _flow_id(trace_id: str, parent: str, child: str) -> int:
    """Stable positive int id for a parent→child flow arrow."""
    return zlib.crc32(f"{trace_id}:{parent}:{child}".encode()) & 0x7FFFFFFF


def merge_perfetto(
    sources: Sequence[TraceSource],
    out_path: str | Path,
    *,
    traces: dict[str, Trace] | None = None,
) -> Path:
    """Merge every source into one Perfetto trace-event file.

    Each source becomes a process (track group) with its label as the
    process name; every event keeps its recording thread as the track.
    Timestamps are absolute-unix rebased to the earliest source anchor,
    so cross-process ordering in the UI is real ordering. For sampled
    traces, parent→child span links that CROSS sources are drawn as flow
    arrows (``ph: s``/``f``), which is what makes the router→replica
    handoff visible as an arrow instead of a coincidence.
    """
    if traces is None:
        traces = collect_traces(sources)
    base = min(
        (s.start_unix_time for s in sources if s.start_unix_time is not None),
        default=0.0,
    )
    # A source with no segment header carries RELATIVE stamps (see
    # load_source) — subtracting the unix-time base would fling its
    # events ~1.7e9 s before everything else and scramble cross-process
    # ordering. Rebase such sources so their t=0 lands at the merge
    # base: internally self-consistent, but NOT time-aligned with the
    # anchored sources — they're listed in ``otherData.unaligned`` so
    # the CLI can warn.
    unaligned = [s.label for s in sources if s.start_unix_time is None]
    trace_events: list[dict[str, Any]] = []
    # Where each span was recorded: (pid, tid, ts, dur) for flow anchors.
    span_pos: dict[tuple[str, str], tuple[int, int, float, float]] = {}
    for pid, src in enumerate(sources):
        trace_events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": src.label},
            }
        )
        src_base = 0.0 if src.start_unix_time is None else base
        tids: dict[str, int] = {}
        for ev in src.events:
            thread = ev.get("thread", "MainThread")
            if thread not in tids:
                tids[thread] = len(tids) + 1
                trace_events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tids[thread],
                        "args": {"name": thread},
                    }
                )
            ts = (float(ev["_abs_ts"]) - src_base) * 1e6
            dur = float(ev.get("dur_us", 0))
            ph = ev.get("ph", "X")
            out: dict[str, Any] = {
                "name": ev.get("name", "?"),
                "cat": ev.get("cat", "train"),
                "ph": ph,
                "ts": ts,
                "pid": pid,
                "tid": tids[thread],
            }
            if ph == "X":
                out["dur"] = dur
            if ph == "i":
                out["s"] = "t"
            args = dict(ev.get("args") or {})
            if "step" in ev:
                args["step"] = ev["step"]
            if ev.get("rolled_back"):
                args["rolled_back"] = True
            if args:
                out["args"] = args
            trace_events.append(out)
            if ev.get("cat") == "trace":
                tid_ = args.get("trace_id")
                sid = args.get("span_id")
                if tid_ and sid:
                    span_pos[(str(tid_), str(sid))] = (
                        pid, tids[thread], ts, dur,
                    )
    # Flow arrows for cross-source parent→child links.
    for trace in traces.values():
        for span in trace.spans:
            if not span.parent_span_id:
                continue
            parent = trace.get(span.parent_span_id)
            if parent is None or parent.source == span.source:
                continue
            src_pos = span_pos.get((trace.trace_id, parent.span_id))
            dst_pos = span_pos.get((trace.trace_id, span.span_id))
            if src_pos is None or dst_pos is None:
                continue
            fid = _flow_id(trace.trace_id, parent.span_id, span.span_id)
            trace_events.append(
                {
                    "name": "trace_link",
                    "cat": "trace",
                    "ph": "s",
                    "id": fid,
                    "ts": src_pos[2],
                    "pid": src_pos[0],
                    "tid": src_pos[1],
                }
            )
            trace_events.append(
                {
                    "name": "trace_link",
                    "cat": "trace",
                    "ph": "f",
                    "bp": "e",
                    "id": fid,
                    "ts": dst_pos[2],
                    "pid": dst_pos[0],
                    "tid": dst_pos[1],
                }
            )
    payload = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "sources": [str(s.path) for s in sources],
            "base_unix_time": base,
            "traces": len(traces),
            "unaligned": unaligned,
        },
    }
    target = Path(out_path)
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(payload), encoding="utf-8")
    return target
