"""Goodput ledger: cross-segment wall-clock attribution from durable
artifacts (the port's copy of ``llmtrain_tpu/telemetry/goodput.py``).

Of the total wall-clock a run consumed, how much became training
progress? Every second between the first segment's process start and the
run's end is attributed to a fixed taxonomy:

* ``productive_train`` — step executions that survived into the final
  trajectory (the LAST execution of each optimizer step);
* ``recomputed``      — step executions later re-run, after an in-process
  spike rollback or a resume from an older commit (the replay cost the
  chaos/fleet drills pay for crash consistency);
* ``compile``         — segment 0's window from process start to the first
  dispatched step (init + data setup + first-step compile);
* ``data_wait``       — host blocked waiting on the input pipeline;
* ``checkpoint``      — save gather + commit wait + rollback restore;
* ``eval``            — interval evaluation;
* ``restart_overhead``— process death → the NEXT segment's first
  dispatched step (the cross-segment gap seen from segment boundaries
  plus the replacement process's warmup; on k8s this includes pod
  reschedule time, visible as a beacon gap);
* ``suspended``       — fleet allocation-0 windows carved out of
  restart_overhead (scheduler decisions, not failures);
* ``unattributed``    — the residual (untimed host work: logging, report
  writes, metric flushes).

Everything is computed POST-HOC from durable artifacts — the per-run
``telemetry/timeline.jsonl`` (whose per-process segment header/footer
lines order segments without file mtimes), checkpoint manifests, and the
watchdog heartbeat file — so the ledger survives SIGKILL and can be
rendered for any past run by ``llmtrain goodput --run-dir`` with every
process dead. The invariant the tests pin: the categories sum to the
total wall-clock exactly (residual is a category, not an error term).

``promotions.jsonl`` (the promote lifecycle's ledger) is not read yet: a
run dir holding one raises ``NotImplementedError`` (ROADMAP.md queue A:
lifecycle and fleet).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Iterable

from ..utils.logging import get_logger

logger = get_logger()

CATEGORIES = (
    "productive_train",
    "recomputed",
    "compile",
    "data_wait",
    "checkpoint",
    "eval",
    "restart_overhead",
    "suspended",
    "unattributed",
)

# Span-name → category map for the step-loop spans the trainer records on
# the main thread. Restricting attribution to THIS whitelist keeps
# concurrent producer-thread spans (prefetch assembly overlaps the step)
# from being double-counted against wall-clock.
_DATA_SPANS = frozenset({"data_wait"})
_CKPT_SPANS = frozenset({"checkpoint_save", "checkpoint_wait", "rollback_restore"})
_EVAL_SPANS = frozenset({"eval"})

_MANIFEST_RE = re.compile(r"step_(\d+)\.manifest\.json$")


class _Segment:
    """One process lifetime of the run, delimited by timeline header lines."""

    def __init__(self, segment_id: int, start: float) -> None:
        self.segment_id = segment_id
        self.start = start
        self.end: float | None = None  # footer end_unix_time when clean
        self.clean_end = False
        self.events: list[dict[str, Any]] = []


def _parse_segments(timeline_path: Path) -> list[_Segment]:
    """Split the (append-mode, cross-process) JSONL into ordered segments.

    Tolerant by design: a SIGKILL can tear the final line mid-write, and
    pre-ledger runs have no header lines at all (→ empty result; the
    ledger is unavailable rather than wrong)."""
    segments: list[_Segment] = []
    try:
        text = timeline_path.read_text(encoding="utf-8")
    except OSError as exc:
        logger.warning("goodput: timeline %s unreadable (%s)", timeline_path, exc)
        return []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except ValueError:
            continue  # torn tail line from a mid-write kill
        if not isinstance(event, dict):
            continue
        name = event.get("name")
        if name == "segment_start" and "start_unix_time" in event:
            segments.append(
                _Segment(int(event.get("segment_id", len(segments))),
                         float(event["start_unix_time"]))
            )
        elif name == "segment_end" and segments and "end_unix_time" in event:
            segments[-1].end = float(event["end_unix_time"])
            segments[-1].clean_end = True
        elif segments:
            segments[-1].events.append(event)
    segments.sort(key=lambda s: (s.segment_id, s.start))
    return segments


def _span_seconds(events: Iterable[dict[str, Any]], names: frozenset[str]) -> float:
    return sum(
        e.get("dur_us", 0) / 1e6
        for e in events
        if e.get("ph") == "X" and e.get("name") in names
    )


def final_committed_step(ckpt_dir: Path) -> int | None:
    """Newest manifest-committed step — read-only, no payload hashing."""
    best: int | None = None
    if not ckpt_dir.is_dir():
        return None
    for path in ckpt_dir.iterdir():
        m = _MANIFEST_RE.match(path.name)
        if m:
            step = int(m.group(1))
            best = step if best is None else max(best, step)
    return best


def _carve_suspensions(
    gap_start: float,
    gap_end: float,
    windows: Iterable[tuple[float, float]],
) -> float:
    """Seconds of [gap_start, gap_end] covered by suspension windows."""
    covered = 0.0
    for w0, w1 in windows:
        lo, hi = max(gap_start, float(w0)), min(gap_end, float(w1))
        if hi > lo:
            covered += hi - lo
    return min(covered, max(0.0, gap_end - gap_start))


def compute_goodput(
    run_dir: str | Path,
    *,
    suspensions: Iterable[tuple[float, float]] | None = None,
    heartbeat_name: str = "heartbeat",
) -> dict[str, Any] | None:
    """Build the ledger for one run directory, or None when the run has no
    segment-delimited timeline (pre-ledger runs, telemetry disabled).

    ``suspensions`` are wall-clock (t0, t1) allocation-0 windows supplied
    by the fleet supervisor; the overlap with cross-segment gaps moves
    from ``restart_overhead`` to ``suspended``.
    """
    run_dir = Path(run_dir)
    timeline_path = run_dir / "telemetry" / "timeline.jsonl"
    if not timeline_path.is_file():
        return None
    segments = _parse_segments(timeline_path)
    if not segments:
        return None
    windows = [(float(a), float(b)) for a, b in (suspensions or [])]

    # Segment end: footer when the process exited cleanly; otherwise the
    # newest event timestamp, extended (last segment only) by the watchdog
    # heartbeat mtime — the beacon often outlives the last flushed event
    # on a SIGKILL, and that stranded progress is real wall-clock.
    hb = run_dir / heartbeat_name
    hb_mtime = hb.stat().st_mtime if hb.is_file() else None
    for idx, seg in enumerate(segments):
        event_end = max(
            ((e.get("ts_us", 0) + e.get("dur_us", 0)) / 1e6 for e in seg.events),
            default=0.0,
        )
        if seg.end is None:
            seg.end = seg.start + event_end
            if idx == len(segments) - 1 and hb_mtime is not None:
                seg.end = max(seg.end, hb_mtime)
        if idx + 1 < len(segments):
            # A crashed segment's inferred end can never run past the next
            # process's start (clock jitter / stale heartbeat guard).
            seg.end = min(seg.end, segments[idx + 1].start)
        seg.end = max(seg.end, seg.start)

    # Step executions in global order; the LAST execution of each step is
    # the one that survived into the final trajectory — every earlier
    # execution (rollback replay, resume-from-older-commit) is recomputed.
    executions: list[tuple[int, int, float]] = []  # (seg_idx, step, dur_sec)
    for idx, seg in enumerate(segments):
        for e in seg.events:
            if e.get("ph") == "X" and e.get("name") == "host_dispatch" and "step" in e:
                executions.append((idx, int(e["step"]), e.get("dur_us", 0) / 1e6))
    last_exec_index: dict[int, int] = {}
    for i, (_, step, _) in enumerate(executions):
        last_exec_index[step] = i
    productive_ids = set(last_exec_index.values())

    seg_rows: list[dict[str, Any]] = []
    totals = {c: 0.0 for c in CATEGORIES}
    exec_cursor = 0
    for idx, seg in enumerate(segments):
        cats = {c: 0.0 for c in CATEGORIES}
        seg_total = seg.end - seg.start
        seg_execs: list[tuple[int, int, float]] = []
        while exec_cursor < len(executions) and executions[exec_cursor][0] == idx:
            seg_execs.append(executions[exec_cursor])
            exec_cursor += 1
        # The pre-step window ends where the step loop's own accounting
        # begins: the FIRST data_wait/host_dispatch span (data_wait for
        # step 1 starts before its dispatch — ending at the dispatch would
        # double-count the first batch's assembly).
        first_step_ts = min(
            (
                e.get("ts_us", 0) / 1e6
                for e in seg.events
                if e.get("ph") == "X"
                and e.get("name") in ("data_wait", "host_dispatch")
                and "step" in e
            ),
            default=None,
        )
        pre_step = seg_total if first_step_ts is None else min(first_step_ts, seg_total)
        gap = 0.0
        if idx == 0:
            cats["compile"] = pre_step
        else:
            gap = max(0.0, seg.start - segments[idx - 1].end)
            suspended = _carve_suspensions(segments[idx - 1].end, seg.start, windows)
            cats["suspended"] = suspended
            cats["restart_overhead"] = gap - suspended + pre_step
        cats["data_wait"] = _span_seconds(seg.events, _DATA_SPANS)
        cats["checkpoint"] = _span_seconds(seg.events, _CKPT_SPANS)
        cats["eval"] = _span_seconds(seg.events, _EVAL_SPANS)
        sync_sec = _span_seconds(seg.events, frozenset({"interval_sync"}))
        n_total = len(seg_execs)
        offset = exec_cursor - n_total
        prod_exec = sum(
            d for j, (_, _, d) in enumerate(seg_execs) if (offset + j) in productive_ids
        )
        rec_exec = sum(d for _, _, d in seg_execs) - prod_exec
        n_prod = sum(1 for j in range(n_total) if (offset + j) in productive_ids)
        prod_frac = (n_prod / n_total) if n_total else 1.0
        cats["productive_train"] = prod_exec + sync_sec * prod_frac
        cats["recomputed"] = rec_exec + sync_sec * (1.0 - prod_frac)
        known = sum(v for k, v in cats.items() if k != "unattributed") - gap
        cats["unattributed"] = max(0.0, seg_total - known)
        if known > seg_total > 0:
            # Clock-jitter overshoot (sub-ms in practice): scale the
            # in-segment categories so the ledger balances exactly.
            scale = (seg_total + gap) / (known + gap)
            for k in cats:
                cats[k] *= scale
        for k, v in cats.items():
            totals[k] += v
        seg_rows.append(
            {
                "segment_id": seg.segment_id,
                "start_unix_time": round(seg.start, 3),
                "end_unix_time": round(seg.end, 3),
                "duration_sec": round(seg_total, 3),
                "clean_end": seg.clean_end,
                "steps_executed": n_total,
                "first_step": min((s for _, s, _ in seg_execs), default=None),
                "last_step": max((s for _, s, _ in seg_execs), default=None),
                "categories": {k: round(v, 3) for k, v in cats.items()},
            }
        )

    wall = segments[-1].end - segments[0].start
    productive = totals["productive_train"]
    ledger = {
        "wall_clock_sec": round(wall, 3),
        "goodput_frac": round(productive / wall, 4) if wall > 0 else 0.0,
        "categories": {k: round(v, 3) for k, v in totals.items()},
        "num_segments": len(segments),
        "segments": seg_rows,
        "final_step": final_committed_step(run_dir / "checkpoints"),
        "balance_error_sec": round(wall - sum(totals.values()), 3),
        "source": {
            "timeline": str(timeline_path),
            "heartbeat_used": hb_mtime is not None,
            "suspension_windows": len(windows),
        },
    }
    promotions = _promotions_block(run_dir)
    if promotions is not None:
        ledger["promotions"] = promotions
    return ledger


def _promotions_block(run_dir: Path) -> dict[str, Any] | None:
    """Promotion-lifecycle attribution from ``promotions.jsonl``, which
    ``llmtrain promote`` writes beside the run. The lifecycle ledger's
    reader is not ported: a run dir holding the file is refused rather than
    given a ledger without its promotions block."""
    path = run_dir / "promotions.jsonl"
    if not path.is_file():
        return None
    raise NotImplementedError(
        f"{path}: the goodput ledger's promotions block (lifecycle/ledger.py) is not "
        "yet ported to llmtrain_tpu_torch (ROADMAP.md queue A: lifecycle and fleet)"
    )


def render_goodput_md(ledger: dict[str, Any]) -> str:
    """Human-readable ledger — the report.md section and the CLI output."""
    wall = ledger["wall_clock_sec"]
    lines = [
        f"- wall clock: {wall}s across {ledger['num_segments']} segment(s), "
        f"goodput_frac = {ledger['goodput_frac']}"
        + (
            f", final committed step {ledger['final_step']}"
            if ledger.get("final_step") is not None
            else ""
        ),
        "",
        "| category | seconds | frac |",
        "|---|---|---|",
    ]
    for cat in CATEGORIES:
        sec = ledger["categories"].get(cat, 0.0)
        frac = (sec / wall) if wall > 0 else 0.0
        lines.append(f"| {cat} | {sec} | {frac:.4f} |")
    lines += [
        "",
        "| segment | dur_s | steps | productive | recomputed | "
        "restart | clean_end |",
        "|---|---|---|---|---|---|---|",
    ]
    for seg in ledger["segments"]:
        c = seg["categories"]
        lines.append(
            f"| {seg['segment_id']} | {seg['duration_sec']} | "
            f"{seg['steps_executed']} | {c['productive_train']} | "
            f"{c['recomputed']} | {c['restart_overhead']} | "
            f"{seg['clean_end']} |"
        )
    promos = ledger.get("promotions")
    if promos is not None:
        d = promos["decisions"]
        lines += [
            "",
            f"- promotions: {d['promote']} promoted, {d['rollback']} rolled "
            f"back, {d['abort']} aborted of {d['canary_start']} canaried"
            + (
                f"; serving step {promos['last_promoted_step']}"
                if promos.get("last_promoted_step") is not None
                else ""
            ),
        ]
        for e in promos.get("events", []):
            reason = f" ({e['reason']})" if e.get("reason") else ""
            lines.append(f"  - step {e['step']}: {e['decision']}{reason}")
    return "\n".join(lines) + "\n"


def goodput_gauges(ledger: dict[str, Any]) -> dict[str, float]:
    """Flat ``goodput/*`` metric map (→ ``llmtrain_goodput_*`` in the
    Prometheus rendering) for one computed ledger."""
    out = {
        "goodput/frac": float(ledger["goodput_frac"]),
        "goodput/wall_clock_sec": float(ledger["wall_clock_sec"]),
        "goodput/segments": float(ledger["num_segments"]),
    }
    for cat in CATEGORIES:
        out[f"goodput/{cat}_sec"] = float(ledger["categories"].get(cat, 0.0))
    promos = ledger.get("promotions")
    if promos is not None:
        for decision, count in promos["decisions"].items():
            out[f"goodput/promotions_{decision}"] = float(count)
        if promos.get("last_promoted_step") is not None:
            out["goodput/promoted_step"] = float(promos["last_promoted_step"])
    return out


__all__ = [
    "CATEGORIES",
    "compute_goodput",
    "final_committed_step",
    "goodput_gauges",
    "render_goodput_md",
]
