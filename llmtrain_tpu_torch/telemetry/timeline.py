"""Structured event timeline (the port's copy of
``llmtrain_tpu/telemetry/timeline.py``): spans + instants, JSONL + Perfetto.

Every span and instant event lands in one ordered stream that is

* appended to a ``timeline.jsonl`` at each flush point (one JSON object
  per line, JAX's schema key for key, so each package's ``trace`` reads the
  other's files), and
* exported as a Chrome/Perfetto trace-event JSON (``trace.json``) that
  ``ui.perfetto.dev`` renders as a track per thread.

Alignment with device profiles: where JAX enters a
``jax.profiler.TraceAnnotation``, ``span`` enters a
``torch.profiler.record_function`` of the same name, and
:func:`step_annotation` wraps a step in one — so under an active
``torch.profiler`` window the framework spans appear as named host regions
above the CUDA kernels they launched. An annotation that cannot be entered
degrades to nothing; the event itself is always recorded.

Rollback semantics: events recorded during a window that is later rolled
back are NOT dropped — :meth:`EventTimeline.tag_rollback` marks them
``rolled_back: true``.

Thread safety: several threads record concurrently (scheduler step loops,
HTTP handlers, the router's dispatch threads); all mutation is under one
lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Iterator

from ..utils.logging import get_logger

logger = get_logger()


def step_annotation(step: int, *, enabled: bool = True):
    """A ``torch.profiler.record_function`` region ``train#{step}`` around
    optimizer step ``step`` (JAX: ``StepTraceAnnotation("train",
    step_num=step)``).

    Best-effort: profiling alignment must never be able to kill a step, so
    a failure to build the region degrades to a nullcontext.
    """
    if not enabled:
        return nullcontext()
    return _trace_annotation(f"train#{int(step)}")


def _trace_annotation(name: str):
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — alignment is optional, the event is not
        return nullcontext()


class EventTimeline:
    """Append-only event stream with bounded memory and JSONL persistence.

    ``jsonl_path`` None keeps the timeline memory-only (non-main ranks,
    eval-only runs). ``max_events`` bounds the retained list; overflow
    drops the OLDEST flushed events (the JSONL already has them) and
    counts the drop so the Perfetto export can say it is partial.
    """

    def __init__(
        self,
        jsonl_path: str | Path | None = None,
        *,
        process_index: int = 0,
        max_events: int = 200_000,
        xprof_annotations: bool = True,
        enabled: bool = True,
    ) -> None:
        # enabled=False makes every recording call a true no-op (no lock,
        # no retained dicts, no record_function) so the master telemetry
        # switch removes the subsystem from the hot path entirely.
        # ``xprof_annotations`` keeps JAX's name (telemetry.xprof_annotations):
        # here it enters torch.profiler.record_function regions.
        self._enabled = enabled
        self._jsonl_path = Path(jsonl_path) if jsonl_path is not None else None
        self._process_index = process_index
        self._max_events = max(1000, int(max_events))
        self._xprof = xprof_annotations
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._flushed = 0  # events [0, _flushed) are already on disk
        self._dropped = 0
        # Event timestamps are perf_counter-relative microseconds; the
        # wall-clock anchor lets post-processing map them to real time.
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        # Segment identity: the JSONL is opened in append mode, so
        # successive segments of one run share ONE file — an EAGERLY written
        # header line per process delimits them (segment_id = headers
        # already on disk), and its start_unix_time anchors the file's
        # perf_counter stamps for cross-process alignment (trace_collect).
        self._segment_id = 0
        self._segment_ended = False
        if self._enabled and self._jsonl_path is not None:
            self._segment_id = self._write_segment_header()

    # ------------------------------------------------------------- recording

    @property
    def origin_unix_time(self) -> float:
        return self._wall0

    @property
    def segment_id(self) -> int:
        """This process's 0-based position in the run's segment sequence."""
        return self._segment_id

    def _write_segment_header(self) -> int:
        """Append this process's segment-start record; returns its id.

        Best-effort like every other persistence path: an unwritable disk
        degrades to a memory-only segment (id from whatever was readable),
        never an exception in the constructor."""
        marker = '"name": "segment_start"'
        segment_id = 0
        try:
            if self._jsonl_path.is_file():
                segment_id = self._jsonl_path.read_text(
                    encoding="utf-8"
                ).count(marker)
        except OSError:
            pass
        header = {
            "name": "segment_start",
            "ph": "seg",
            "segment_id": segment_id,
            "start_unix_time": self._wall0,
            "process_index": self._process_index,
            "pid": os.getpid(),
        }
        try:
            self._jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            with self._jsonl_path.open("a", encoding="utf-8") as fh:
                fh.write(json.dumps(header, sort_keys=True) + "\n")
        except OSError as exc:
            logger.warning(
                "timeline segment header to %s failed (%s); continuing",
                self._jsonl_path,
                exc,
            )
        return segment_id

    def end_segment(self) -> None:
        """Append the clean-exit footer (idempotent). Crashed segments
        never reach this."""
        if not self._enabled or self._jsonl_path is None or self._segment_ended:
            return
        self._segment_ended = True
        footer = {
            "name": "segment_end",
            "ph": "seg",
            "segment_id": self._segment_id,
            "end_unix_time": time.time(),
        }
        try:
            with self._jsonl_path.open("a", encoding="utf-8") as fh:
                fh.write(json.dumps(footer, sort_keys=True) + "\n")
        except OSError as exc:
            logger.warning(
                "timeline segment footer to %s failed (%s); continuing",
                self._jsonl_path,
                exc,
            )

    def _now_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def _append(self, event: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self._max_events:
                # Drop the oldest FLUSHED prefix first: those lines are
                # already durable in the JSONL. Unflushed events are only
                # dropped when flushing has no sink at all (memory-only).
                drop = len(self._events) - self._max_events
                drop = min(drop, self._flushed) if self._jsonl_path else drop
                if drop > 0:
                    del self._events[:drop]
                    self._flushed = max(0, self._flushed - drop)
                    self._dropped += drop

    @contextmanager
    def span(
        self, name: str, *, cat: str = "train", step: int | None = None, **args: Any
    ) -> Iterator[None]:
        """Record a duration event around the body; never raises from the
        recording itself (the body's exceptions propagate untouched)."""
        if not self._enabled:
            yield
            return
        start = self._now_us()
        cm = _trace_annotation(name) if self._xprof else nullcontext()
        try:
            with cm:
                yield
        finally:
            end = self._now_us()
            event: dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts_us": start,
                "dur_us": max(0, end - start),
                "thread": threading.current_thread().name,
            }
            if step is not None:
                event["step"] = int(step)
            if args:
                event["args"] = args
            self._append(event)

    def record(
        self,
        name: str,
        *,
        t0: float,
        t1: float,
        cat: str = "train",
        step: int | None = None,
        **args: Any,
    ) -> None:
        """Record a duration event from perf_counter stamps the caller
        already took — the hot loop's path: its interval accumulators and
        the timeline share ONE set of clock reads, so the span record and
        the `train/data_wait_ms` family can never drift apart."""
        if not self._enabled:
            return
        event: dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts_us": int((t0 - self._t0) * 1e6),
            "dur_us": max(0, int((t1 - t0) * 1e6)),
            "thread": threading.current_thread().name,
        }
        if step is not None:
            event["step"] = int(step)
        if args:
            event["args"] = args
        self._append(event)

    def instant(
        self,
        name: str,
        *,
        cat: str = "event",
        step: int | None = None,
        t: float | None = None,
        **args: Any,
    ) -> None:
        """Point event; ``t`` (a perf_counter stamp the caller already
        took) backdates it — the trace flush path records marks at their
        TRUE time, not the flush time."""
        if not self._enabled:
            return
        event: dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "ts_us": self._now_us() if t is None else int((t - self._t0) * 1e6),
            "dur_us": 0,
            "thread": threading.current_thread().name,
        }
        if step is not None:
            event["step"] = int(step)
        if args:
            event["args"] = args
        self._append(event)

    def tag_rollback(self, first_step: int, last_step: int) -> None:
        """Mark every retained event of steps [first_step, last_step] as
        belonging to a rolled-back window. Runs BEFORE the boundary flush,
        so unflushed events carry the tag into the JSONL; events of the
        window flushed in earlier intervals keep their lines but the
        paired ``rollback`` instant (recorded by the trainer) gives
        post-processing the window to re-tag them."""
        with self._lock:
            for event in self._events:
                step = event.get("step")
                if step is not None and first_step <= step <= last_step:
                    event["rolled_back"] = True

    # ----------------------------------------------------------- persistence

    def flush(self) -> None:
        """Append every not-yet-persisted event to the JSONL (no-op when
        memory-only). Never raises: a full disk must not kill the step loop."""
        if self._jsonl_path is None:
            return
        with self._lock:
            pending = self._events[self._flushed :]
            self._flushed = len(self._events)
        if not pending:
            return
        try:
            self._jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            with self._jsonl_path.open("a", encoding="utf-8") as fh:
                for event in pending:
                    fh.write(json.dumps(event, sort_keys=True) + "\n")
        except OSError as exc:
            logger.warning("timeline flush to %s failed (%s); continuing", self._jsonl_path, exc)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    # -------------------------------------------------------------- analysis

    def span_totals(self) -> dict[str, dict[str, float]]:
        """Wall-clock breakdown: {span name: {count, total_ms, max_ms}} over
        retained duration events — the report's and bench's summary input."""
        totals: dict[str, dict[str, float]] = {}
        for event in self.events():
            if event.get("ph") != "X":
                continue
            entry = totals.setdefault(
                event["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            )
            ms = event["dur_us"] / 1e3
            entry["count"] += 1
            entry["total_ms"] += ms
            entry["max_ms"] = max(entry["max_ms"], ms)
        for entry in totals.values():
            entry["total_ms"] = round(entry["total_ms"], 3)
            entry["max_ms"] = round(entry["max_ms"], 3)
        return totals

    def event_counts(self) -> dict[str, int]:
        """{instant-event name: occurrences} — rollbacks, faults, warnings."""
        counts: dict[str, int] = {}
        for event in self.events():
            if event.get("ph") == "i":
                counts[event["name"]] = counts.get(event["name"], 0) + 1
        return counts

    # ------------------------------------------------------------- exporters

    def export_perfetto(self, path: str | Path) -> Path | None:
        """Write the retained events as a Chrome/Perfetto trace-event JSON.

        ``pid`` is the process index, ``tid`` a stable small int per
        recording thread (with ``thread_name`` metadata so Perfetto shows
        real names). Returns the path, or None when the write failed
        (logged — exporting must not fail the run it describes)."""
        target = Path(path)
        events = self.events()
        tids: dict[str, int] = {}
        trace_events: list[dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._process_index,
                "tid": 0,
                "args": {"name": f"llmtrain host {self._process_index}"},
            }
        ]
        for event in events:
            thread = event.get("thread", "MainThread")
            if thread not in tids:
                tids[thread] = len(tids) + 1
                trace_events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": self._process_index,
                        "tid": tids[thread],
                        "args": {"name": thread},
                    }
                )
            out: dict[str, Any] = {
                "name": event["name"],
                "cat": event.get("cat", "train"),
                "ph": event.get("ph", "X"),
                "ts": event["ts_us"],
                "pid": self._process_index,
                "tid": tids[thread],
            }
            if out["ph"] == "X":
                out["dur"] = event.get("dur_us", 0)
            if out["ph"] == "i":
                out["s"] = "t"  # thread-scoped instant marker
            args = dict(event.get("args") or {})
            if "step" in event:
                args["step"] = event["step"]
            if event.get("rolled_back"):
                args["rolled_back"] = True
            if args:
                out["args"] = args
            trace_events.append(out)
        payload = {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "origin_unix_time": self._wall0,
                "dropped_events": self._dropped,
            },
        }
        try:
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(json.dumps(payload), encoding="utf-8")
            return target
        except OSError as exc:
            logger.warning("perfetto export to %s failed (%s)", target, exc)
            return None


__all__ = ["EventTimeline", "step_annotation"]
