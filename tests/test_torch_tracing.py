"""The port's request tracing, event timeline, run report and trace
collector against the JAX package's (all pure Python on both sides).

* ``TraceContext`` parses and prints ``traceparent`` headers as JAX's does,
  malformed ones included;
* ``TailSampler.decide`` makes JAX's decisions on a seeded latency stream;
* ``Tracer.finish`` hands the timeline JAX's records for the same buffered
  spans;
* a fleet's timelines written by either package are read by both
  collectors with the same ``summarize()``, ``critical_path()``,
  ``format_tree()`` and merged Perfetto file (flow ids included);
* ``export_perfetto`` and the JSONL lines carry JAX's keys and values;
* ``build_report``/``render_markdown`` give JAX's report for the same
  serving block, registry values and timeline.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.telemetry import report as jax_report
from llmtrain_tpu.telemetry import timeline as jax_timeline
from llmtrain_tpu.telemetry import trace_collect as jax_collect
from llmtrain_tpu.telemetry import tracing as jax_tracing
from llmtrain_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from llmtrain_tpu_torch.telemetry import report as port_report
from llmtrain_tpu_torch.telemetry import timeline as port_timeline
from llmtrain_tpu_torch.telemetry import trace_collect as port_collect
from llmtrain_tpu_torch.telemetry import tracing as port_tracing
from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry as PortRegistry

PACKAGES = {
    "port": (port_tracing, port_timeline, port_collect),
    "jax": (jax_tracing, jax_timeline, jax_collect),
}
_T, _S = "ab" * 16, "cd" * 8

_HEADERS = [
    f"00-{_T}-{_S}-01",
    f"00-{_T}-{_S}-00",
    f"  00-{_T.upper()}-{_S}-03  ",
    f"00-{_T}-{_S}-02",
    "",
    None,
    "garbage",
    "00-zz-bb-01",
    f"01-{_T}-{_S}",
    f"01-{_T}-{_S}-01",
    f"00-{'0' * 32}-{_S}-01",
    f"00-{_T}-{'0' * 16}-01",
    f"00-{_T[:-1]}-{_S}-01",
    f"00-{_T}-{_S}-0g",
]


@pytest.mark.parametrize("header", _HEADERS, ids=range(len(_HEADERS)))
def test_traceparent_answers_as_jax(header) -> None:
    ours = port_tracing.TraceContext.from_traceparent(header)
    theirs = jax_tracing.TraceContext.from_traceparent(header)
    if theirs is None:
        assert ours is None
        return
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_traceparent() == theirs.to_traceparent()
    child = ours.child()
    assert (child.trace_id, child.parent_span_id, child.forced) == (
        ours.trace_id, ours.span_id, ours.forced)
    assert len(port_tracing.new_trace_id()) == 32 and len(port_tracing.new_span_id()) == 16


@pytest.mark.parametrize("knobs", [dict(), dict(slow_frac=0.2, reservoir=16, warmup=3),
                                   dict(slow_frac=1.0, reservoir=40, warmup=0)],
                         ids=["default", "narrow", "keep-all-slow"])
def test_tail_sampler_decides_as_jax(knobs) -> None:
    rng = np.random.default_rng(7)
    ours, theirs = port_tracing.TailSampler(**knobs), jax_tracing.TailSampler(**knobs)
    got, want = [], []
    for _ in range(400):
        lat = float(rng.lognormal(3.0, 1.0))
        flags = dict(zip(("errored", "failover", "forced"), (rng.random(3) < 0.03).tolist()))
        got.append(ours.decide(lat, **flags))
        want.append(theirs.decide(lat, **flags))
    assert got == want and set(want) > {None, "slow"}
    with pytest.raises(ValueError):
        port_tracing.TailSampler(slow_frac=0.0)


class _Recorder:
    """A duck-typed timeline: keeps every record() call."""

    def __init__(self) -> None:
        self.records: list[tuple[str, dict]] = []

    def record(self, name: str, **kw) -> None:
        self.records.append((name, kw))

    def instant(self, name: str, **kw) -> None:
        pass


def _finish(tracing, case: str, monkeypatch) -> tuple:
    ids = itertools.count()
    monkeypatch.setattr(tracing, "new_span_id", lambda: f"{next(ids):016x}")
    tl = _Recorder()
    sampler = tracing.TailSampler(slow_frac=0.05, reservoir=16, warmup=0)
    for _ in range(16):
        sampler.decide(100.0)
    tracer = tracing.Tracer(tl, sampler=sampler, max_spans=4)
    parent = tracing.TraceContext(_T, _S, None, False) if case == "remote-parent" else None
    tr = tracer.start(parent=parent, root_name="router/request", forced=case == "forced")
    if parent is None:
        tr.ctx = tracing.TraceContext(_T, _S, None, tr.ctx.forced)
    t0 = 50.0
    for i in range(6 if case == "forced" else 2):
        tr.add_span(f"serve/s{i}", t0=t0 + i * 1e-3, t1=t0 + (i + 1) * 1e-3, request_id="p/1")
    tr.add_span("router/http_dispatch", t0=t0, t1=t0 + 0.002, span_id="ee" * 8, replica="r0")
    tr.add_event("serve/prefix_cache", t=t0 + 5e-4, hit=True, matched_tokens=16)
    if case == "error":
        tr.note(error="boom", failover=True)
    reason = tracer.finish(tr, t0=t0, t1=t0 + (0.5 if case == "slow" else 0.01),
                           request_id="p/1", finish_reason="length")
    again = tracer.finish(tr, t0=t0, t1=t0 + 1.0)
    return reason, again, tl.records, tracer.stats()


@pytest.mark.parametrize("case", ["slow", "dropped", "forced", "error", "remote-parent"])
def test_tracer_finish_records_as_jax(case, monkeypatch) -> None:
    ours = _finish(port_tracing, case, monkeypatch)
    theirs = _finish(jax_tracing, case, monkeypatch)
    assert ours == theirs
    assert (ours[0] is None) == (case in ("dropped", "remote-parent"))


def _write_fleet(pkg: str, root: Path) -> list[str]:
    """Three requests through a router and a replica, each process with its
    own timeline and tracer (keep all): the second failed over, the third
    was kept by the replica alone. Returns the trace ids."""
    tracing, timeline, _ = PACKAGES[pkg]
    keep = dict(sampler=tracing.TailSampler(warmup=100))
    router_tl = timeline.EventTimeline(root / "router" / "telemetry" / "timeline.jsonl")
    replica_tl = timeline.EventTimeline(root / "replica0" / "telemetry" / "timeline.jsonl")
    router, replica = tracing.Tracer(router_tl, **keep), tracing.Tracer(replica_tl, **keep)
    base = replica_tl._t0 + 0.5
    out = []
    for n in range(3):
        t = base + n * 0.2
        rt = router.start(root_name="router/request")
        rt.add_span("router/place", t0=t, t1=t + 0.001, replica="replica0")
        if n == 1:
            rt.add_span("router/http_dispatch", t0=t + 0.001, t1=t + 0.011, replica="dead",
                        error="connection refused")
            rt.note(failover=True)
            rt.add_event("router/failover", t=t + 0.011, replica="replica0")
        hop = tracing.TraceContext(rt.trace_id, tracing.new_span_id(), rt.root_span_id, False)
        h0 = t + (0.012 if n == 1 else 0.002)
        st = replica.start(parent=tracing.TraceContext.from_traceparent(hop.to_traceparent()))
        st.add_span("serve/queue_wait", t0=h0 + 0.001, t1=h0 + 0.004, request_id=f"p/{n}")
        st.add_span("serve/prefill", t0=h0 + 0.004, t1=h0 + 0.02 + n * 0.01, request_id=f"p/{n}")
        st.add_event("serve/prefix_cache", t=h0 + 0.004, hit=n > 0, matched_tokens=16 * n)
        st.add_span("serve/decode_phase", t0=h0 + 0.02 + n * 0.01, t1=h0 + 0.08,
                    request_id=f"p/{n}", tokens=8)
        replica.finish(st, t0=h0 + 0.001, t1=h0 + 0.081, request_id=f"p/{n}",
                       finish_reason="length", ttft_ms=19.0)
        rt.add_span("router/http_dispatch", t0=h0, t1=h0 + 0.083, span_id=hop.span_id,
                    replica="replica0")
        if n < 2:
            router.finish(rt, t0=t, t1=h0 + 0.085, request_id=f"p/{n}", finish_reason="length")
        replica_tl.record("serve/decode", t0=h0 + 0.03, t1=h0 + 0.04, cat="serve", batch=1)
        replica_tl.instant("serve/compile", cat="serve", kind="decode", bucket=1)
        out.append(rt.trace_id)
    router_tl.flush()
    replica_tl.flush()
    return out


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_each_collector_reads_the_others_timelines(writer, tmp_path) -> None:
    trace_ids = _write_fleet(writer, tmp_path)
    answers = {}
    for reader, (_, _, collect) in PACKAGES.items():
        sources = collect.discover_sources([tmp_path])
        traces = collect.collect_traces(sources)
        out = tmp_path / f"merged_{reader}.json"
        collect.merge_perfetto(sources, out, traces=traces)
        answers[reader] = dict(
            labels=[s.label for s in sources],
            summary=collect.summarize(traces),
            paths={t: collect.critical_path(tr) for t, tr in traces.items()},
            trees={t: collect.format_tree(tr) for t, tr in traces.items()},
            slowest=[t.trace_id for t in collect.slowest(traces, k=2)],
            merged=json.loads(out.read_text()),
        )
    assert answers["port"] == answers["jax"]
    port = answers["port"]
    assert sorted(port["paths"]) == sorted(trace_ids)
    for tid in trace_ids[:2]:
        cp = port["paths"][tid]
        assert cp["root"] == "router/request"
        assert sum(cp["breakdown"].values()) == pytest.approx(cp["total_ms"], abs=0.05)
    assert port["paths"][trace_ids[2]]["root"] == "serve/request"  # orphaned subtree
    flows = [e for e in port["merged"]["traceEvents"] if e["name"] == "trace_link"]
    assert len(flows) == 2 * 2  # an s/f pair per hop whose both ends were kept


def _same_clock(timeline, path):
    tl = timeline.EventTimeline(path)
    tl._t0, tl._wall0 = 1000.0, 1.7e9
    return tl


# Events stamped by the timeline's own clock reading (span, instant without
# ``t``): their times are this run's, so they are compared without them.
_LIVE = ("serve/prefill", "rollback")


def test_timeline_lines_and_perfetto_match_jax(tmp_path) -> None:
    docs, lines = {}, {}
    for name, (_, timeline, _) in PACKAGES.items():
        path = tmp_path / name / "timeline.jsonl"
        tl = _same_clock(timeline, path)
        tl.record("serve/queue_wait", t0=1000.5, t1=1000.75, cat="serve", request_id="p/0",
                  trace_id=_T)
        tl.record("train/step", t0=1001.0, t1=1001.5, step=3)
        tl.instant("serve/compile", t=1000.6, cat="serve", kind="prefill", bucket=32)
        tl.instant("rollback", step=3)
        tl.tag_rollback(3, 3)
        with tl.span("serve/prefill", cat="serve", request_id="p/0"):
            pass
        tl.flush()
        tl.end_segment()
        raw = [json.loads(x) for x in path.read_text().splitlines()]
        for ev in raw:
            if ev["ph"] == "seg":  # the process and its wall clock
                ev.update({k: 0 for k in ("pid", "start_unix_time", "end_unix_time") if k in ev})
            if ev["name"] in _LIVE:
                ev["ts_us"] = ev["dur_us"] = 0
        lines[name] = raw
        doc = json.loads(tl.export_perfetto(tmp_path / name / "trace.json").read_text())
        for ev in doc["traceEvents"]:
            if ev["name"] in _LIVE:
                ev["ts"] = ev["dur"] = 0
        docs[name] = doc
        assert tl.span_totals()["serve/queue_wait"] == {"count": 1, "total_ms": 250.0,
                                                        "max_ms": 250.0}
    assert lines["port"] == lines["jax"]
    assert docs["port"] == docs["jax"]


def test_annotation_failure_never_loses_the_event(monkeypatch) -> None:
    import torch

    def broken(name):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    tl = port_timeline.EventTimeline(None)
    with tl.span("serve/decode", cat="serve"):
        pass
    with port_timeline.step_annotation(7):
        pass
    assert [e["name"] for e in tl.events()] == ["serve/decode"]
    monkeypatch.undo()
    with pytest.raises(KeyError):  # the body's own errors still propagate
        with tl.span("serve/decode", cat="serve"):
            raise KeyError("body")
    assert len(tl.events()) == 2
    off = port_timeline.EventTimeline(None, enabled=False)
    with off.span("x"):
        pass
    off.instant("y")
    assert off.events() == []


def _serving_block() -> dict:
    return {
        "requests": {"submitted": 12, "completed": 11, "failed": 1, "timed_out": 0},
        "slo": {"ttft_ms": {"p50": 12.5, "p95": 40.25, "p99": 81.0},
                "per_token_ms": {"p50": 2.5, "p95": 7.125, "p99": 8.0}},
        "throughput": {"tokens_per_sec": 1234.5678, "new_tokens": 96, "wall_sec": 0.25},
        "occupancy": {"peak": 4, "mean": 2.2889, "max_batch_slots": 8},
        "kv_pool": {"peak_allocated_blocks": 17, "capacity_blocks": 64, "block_tokens": 8},
        "compile": {"prefill_programs": 2, "decode_programs": 2, "budget": 6,
                    "within_budget": True},
        "parity": {"checked": 11, "mismatched": 0, "bitwise_identical": True},
        "tracing": {"finished": 12, "kept": {"warmup": 12}},
        "router": {"replicas_healthy": 2, "affinity_routed": 10},
    }


def test_report_matches_jax(tmp_path) -> None:
    reports = {}
    for name, registry, (_, timeline, _), report in (
        ("port", PortRegistry(), PACKAGES["port"], port_report),
        ("jax", JaxRegistry(None), PACKAGES["jax"], jax_report),
    ):
        registry.publish({"serve/queue_depth": 3.0, "serve/tokens_generated": 96.0})
        registry.inc("serve/requests", 11)
        registry.inc('serve/rejected{reason="queue_full"}')
        tl = _same_clock(timeline, None)
        tl.record("serve/prefill", t0=1000.0, t1=1000.0125, cat="serve")
        tl.record("serve/decode", t0=1000.02, t1=1000.0205, cat="serve")
        tl.instant("serve/compile", cat="serve", kind="decode", bucket=4)
        rep = report.build_report(run_id="serve-bench", run_name="tiny", registry=registry,
                                  timeline=tl, memory=None, wall_time_sec=0.25,
                                  serving=_serving_block())
        json_path, md_path = report.write_reports(tmp_path / name, rep)
        reports[name] = (rep, json_path.read_text(), md_path.read_text(),
                         report.render_markdown(rep))
    assert reports["port"] == reports["jax"]
    assert "## Serving" in reports["port"][2]
    # What the refusals of the goodput and attribution sections became:
    # both render as JAX's, key for key and line for line.
    from llmtrain_tpu.telemetry.goodput import CATEGORIES
    from llmtrain_tpu_torch.telemetry.profiling import build_perf_attribution

    cats = {c: float(i) for i, c in enumerate(CATEGORIES)}
    goodput = {"wall_clock_sec": 36.0, "goodput_frac": 0.0, "categories": cats,
               "num_segments": 1, "final_step": 8, "balance_error_sec": 0.0,
               "segments": [{"segment_id": 0, "duration_sec": 36.0, "steps_executed": 8,
                             "clean_end": True, "categories": cats}]}
    top = [{"op": "mm", "count": 19, "flops": 1.5e7, "bytes_accessed": 1.4e6,
            "flops_frac": 0.65, "bytes_frac": 0.09, "class": "compute"}]
    perf = build_perf_attribution(
        executables=[{"name": "train_step", "flops": 2.3e7, "bytes_accessed": 1.6e7,
                      "top_ops": top}],
        peaks={"peak_flops": 2e11, "hbm_bytes_per_sec": 5e10, "ici_bytes_per_sec": 1e10},
        step_time_ms=20.0, tokens_per_step=128.0, palm_flops_per_token=1.8e5,
        measured_mfu=0.0058)
    sections = []
    for registry, timeline, report in ((PortRegistry(), port_timeline, port_report),
                                       (JaxRegistry(None), jax_timeline, jax_report)):
        rep = report.build_report(run_id="r", run_name="n", registry=registry,
                                  timeline=timeline.EventTimeline(None), memory=None,
                                  wall_time_sec=1.0, goodput=goodput, perf_attribution=perf)
        sections.append((json.dumps(rep["goodput"]), json.dumps(rep["perf_attribution"]),
                         report.render_markdown(rep)))
    assert sections[0] == sections[1]
    assert "## Goodput" in sections[0][2] and "## Performance attribution" in sections[0][2]


def test_concurrent_recording_against_flush_loses_nothing(tmp_path) -> None:
    """Recording threads race a flushing thread (a short interpreter switch
    interval forces interleaving): every event lands in the JSONL once."""
    import sys
    import threading

    path = tmp_path / "timeline.jsonl"
    tl = port_timeline.EventTimeline(path)
    tracer = port_tracing.Tracer(tl, sampler=port_tracing.TailSampler(warmup=10**6))
    threads, per_thread = 8, 60
    stop = threading.Event()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def record(t: int) -> None:
            for i in range(per_thread):
                with tl.span("serve/decode", cat="serve", batch=t):
                    pass
                tr = tracer.start()
                tr.add_span("serve/prefill", t0=1.0, t1=2.0)
                tracer.finish(tr, t0=1.0, t1=3.0, request_id=f"{t}/{i}")

        def flush() -> None:
            while not stop.is_set():
                tl.flush()

        flusher = threading.Thread(target=flush)
        flusher.start()
        pool = [threading.Thread(target=record, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        stop.set()
        flusher.join(timeout=60)
        assert not flusher.is_alive() and not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    tl.flush()
    events = [json.loads(x) for x in path.read_text().splitlines()][1:]  # after the header
    n = threads * per_thread
    assert sum(e["name"] == "serve/decode" for e in events) == n
    roots = [e["args"]["request_id"] for e in events if e["name"] == "serve/request"]
    assert sorted(roots) == sorted(f"{t}/{i}" for t in range(threads) for i in range(per_thread))
    assert tracer.stats() == {"finished": n, "kept": {"warmup": n}}
