"""CPU tests of the reading of the port's own spans and counters:
``bench.program_trace`` (the annotated reduction of a profiler trace, the
clocks' agreement), the readers that wait for a run's ``program`` record,
and ``bench.tools.traced_run`` driving a whole traced run of the stand-in
cell at a size a test run holds. A test on the card checks that the
profiler annotates a span of another thread than its own.
"""
import json
import math
import sys
import tempfile
import threading
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import program_trace as pt  # noqa: E402
from bench.tests.test_bench_harness import tiny_base  # noqa: E402
from bench.tools import traced_run  # noqa: E402
from bench.trace import reduce_trace  # noqa: E402

OFF = 7.0e11  # the trace's clock, far from the host's
HOST_FLUSH, WORKER, OTHER, MAIN = 555, 556, 666, 99


def _synthetic_events(markers_apart_us=2.0e6):
    """One flush on thread 555: planning with discovery (a copy to the
    host), a query's replay with two scan blocks (a kernel each) and an
    estimate kernel outside them; a client on 556 waiting on the lock
    throughout; a thread 666 without spans launching three kernels after
    the flush; the benchmark's two marker kernels on thread 99,
    ``markers_apart_us`` apart. The copy, the estimate and the first scan
    kernel name their host event by ``External id`` (an operator, or the
    scan block's annotation), and their runtime events carry a stale
    thread id, 444; the second scan kernel names none."""
    ev = []

    def ann(name, sid, t0, t1, tid):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"{name}#{sid}", "ts": OFF + t0,
                   "dur": t1 - t0, "tid": tid,
                   "args": {"External id": 100 + sid}})

    def launch(t, tid, corr, name, start, dur, cat="kernel", ext=None,
               op=False):
        args = {"correlation": corr}
        if ext is not None:
            args["External id"] = ext
        if op:  # the operator that launched it, on the right thread
            ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::op",
                       "ts": OFF + t - 10, "dur": 20, "tid": tid,
                       "args": {"External id": ext}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": OFF + t, "dur": 2,
                   "tid": 444 if ext is not None else tid, "args": args})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": OFF + start,
                   "dur": dur, "tid": 7, "args": args})

    ann("service.lock_wait", 1, 0, 9000, WORKER)
    ann("service.flush", 2, 1000, 8000, HOST_FLUSH)
    ann("plan", 3, 1100, 3000, HOST_FLUSH)
    ann("plan.discover", 4, 1200, 2900, HOST_FLUSH)
    ann("replay.query", 5, 3100, 7900, HOST_FLUSH)
    ann("scan.block", 6, 3200, 3400, HOST_FLUSH)
    ann("scan.block", 7, 5000, 5200, HOST_FLUSH)
    launch(1300, HOST_FLUSH, 10, "Memcpy DtoH", 1400, 600, "gpu_memcpy",
           ext=900, op=True)
    launch(3300, HOST_FLUSH, 11, "fms_partials", 3350, 40, ext=106)
    launch(5100, HOST_FLUSH, 12, "fms_partials", 5150, 30)
    launch(6000, HOST_FLUSH, 13, "estimate", 6010, 5, ext=901, op=True)
    launch(8500, OTHER, 14, "other", 8600, 50)
    launch(8800, OTHER, 15, "other", 8900, 50)
    launch(9400, OTHER, 16, "other", 9500, 20)
    launch(-1e5, MAIN, 1, "spin_kernel(long)", -1e5 + 10, 3)
    launch(-1e5 + markers_apart_us, MAIN, 2, "spin_kernel(long)",
           -1e5 + markers_apart_us + 10, 3)
    return ev


def _write(events):
    path = Path(tempfile.mkdtemp()) / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.mark.parametrize("apart_us", [2.0e6, 2.0e6 + 1.0e5])
def test_kernels_go_to_the_span_that_launched_them(apart_us):
    """The same whether the two markers lie where the host put them or
    100 ms further apart, as a host stall can place them: the annotations
    carry no offset between clocks."""
    r = pt.reduce_annotated(_write(_synthetic_events(apart_us)))
    assert r["span_device_s"] == pytest.approx(
        {4: 600e-6, 6: 40e-6, 7: 30e-6, 5: 5e-6})
    assert r["device_s_by_span"] == pytest.approx(
        {"plan.discover": 600e-6, "scan.block": 70e-6, "replay.query": 5e-6})
    assert r["flushes"] == 1 and r["whole"] == [OFF + 1000, OFF + 8000]
    assert r["held_device_s"] == pytest.approx(675e-6)  # 666 holds none
    assert r["in_span_device_s"] == pytest.approx(r["held_device_s"])
    assert r["busy_s"] == pytest.approx(795e-6)
    # each gap between device work, by the innermost working span open at
    # its middle; after the flush only the client's lock wait is open, and
    # after that nothing
    assert dict(r["idle_gaps"]) == pytest.approx({
        "plan.discover": 1350e-6, "replay.query": (1760 + 830 + 2585) * 1e-6,
        "service.lock_wait": 250e-6, "outside_spans": 550e-6})
    assert r["spans"][6] == ["scan.block", OFF + 3200, 200]
    assert r["end_us"] == OFF + 9520


def test_the_marker_reduction_drifts_where_the_annotations_do_not():
    """Beside ``reduce_trace``: with its markers 100 ms apart it reports
    the drift, and its clock offset moves the spans it places; the
    annotated reduction reads the same trace alike either way."""
    marks = [(-0.1, -0.1), (1.9, 1.9)]  # host times of the two markers
    out = {}
    for apart in (2.0e6, 2.1e6):
        events = _synthetic_events(apart)
        out[apart] = (reduce_trace(_write(events), 2.0, [], marks, []),
                      pt.reduce_annotated(_write(events)))
    (m0, a0), (m1, a1) = out[2.0e6], out[2.1e6]
    assert m0["clock_drift_us"] == pytest.approx(0.0, abs=1.0)
    assert m1["clock_drift_us"] == pytest.approx(1.0e5)
    assert a0 == a1


def test_clock_agreement_of_annotations_and_host_spans():
    r = pt.reduce_annotated(_write(_synthetic_events()))
    base = 3.0  # host seconds at trace time OFF
    host = [(sid, 0, name, base + 1e-6 * (ts - OFF) + 5e-6 * (sid % 2),
             base + 1e-6 * (ts - OFF + dur), 1, None, {})
            for sid, (name, ts, dur) in r["spans"].items()]
    got = pt.clock_agreement(r, host)
    assert got["spans_matched"] == 7
    assert got["offset_spread_us"] == pytest.approx(5.0, abs=1e-3)
    assert got["duration_gap_us_max"] == pytest.approx(5.0, abs=1e-3)
    assert pt.clock_agreement(None, host) == {}


def _program_run():
    """A run with the port's record: a 10-s window holding two flushes
    (one with two queries, one with one) and three queries resolved."""
    def sp(sid, parent, name, t0, t1, request=None, **attrs):
        return (sid, parent, name, t0, t1, 1, request, attrs)

    spans = [
        sp(1, 0, "service.lock_wait", 0.5, 2.5, caller="result"),
        sp(2, 0, "service.lock_wait", 0.6, 1.0, caller="submit"),
        sp(3, 0, "service.flush", 1.0, 2.0, (11, 12), queries=2),
        sp(4, 3, "plan", 1.0, 1.3, (11, 12), queries=2),
        sp(5, 4, "plan.discover", 1.05, 1.25, (11, 12), queries=2),
        sp(6, 3, "replay.query", 1.3, 1.6, 11),
        sp(7, 6, "scan.block", 1.35, 1.45, 11, tuples=100, snippets=128),
        sp(8, 6, "replay.improve", 1.45, 1.5, 11),
        sp(9, 6, "replay.record", 1.5, 1.55, 11),
        sp(10, 6, "replay.assemble", 1.55, 1.58, 11),
        sp(11, 3, "replay.query", 1.6, 1.9, 12),
        sp(12, 0, "store.drain_wait", 1.46, 1.47),
        sp(13, 0, "ingest.queued", 1.55, 1.75),
        sp(14, 0, "service.lock_wait", 3.0, 4.0, caller="result"),
        sp(15, 0, "service.flush", 4.0, 4.5, (13,), queries=1),
        sp(16, 15, "plan", 4.0, 4.1, (13,), queries=1),
        sp(17, 15, "replay.query", 4.1, 4.5, 13),
        sp(18, 0, "ingest.queued", 4.5, 4.6),
        sp(19, 0, "service.flush", 9.5, 10.5, (14,), queries=1),  # past t1
        sp(20, 0, "service.lock_wait", 9.0, 12.0, caller="result"),
    ]
    queries = [{"in_window": True}] * 3 + [{"in_window": False}]
    trace = {"flushes": 4, "device_s_by_span": {"scan.block": 2e-3}}
    return {"window": (0.0, 10.0), "window_s": 10.0, "queries": queries,
            "program": {"spans": spans, "trace": trace, "counters": {
                "service.empty_flush": 1, "host_copy.count": 12,
                "host_copy.bytes": 3 * 614_000_000}}}


def test_program_readers_on_a_fixture_run():
    run = _program_run()
    got = {m: harness.reader(m)(run) for m in traced_run.PROGRAM_METRICS}
    assert got == pytest.approx({
        "lock_wait_ms": 1e3 * (2.0 + 1.0) / 3,
        "empty_flushes_per_query": 1 / 3,
        "discover_ms_per_flush": 1e3 * 0.2 / 2,
        "plan_ms_per_flush": 1e3 * ((0.3 - 0.2) + 0.1) / 2,
        "replay_ms_per_query": 1e3 * ((0.3 - 0.1 - 0.05 - 0.05) + 0.3
                                      + 0.4) / 3,
        "d2h_mb_per_query": 614.0,
        "host_syncs_per_query": 4.0,
        "scan_device_ms_per_flush": 0.5,
        "improve_drain_wait_ms": 1e3 * 0.01 / 3,
        "ingest_queue_wait_ms": 1e3 * (0.2 + 0.1) / 2,
    })
    for m in traced_run.PROGRAM_METRICS:  # a run without the record
        assert harness.reader(m)({"queries": [], "window": (0, 1)}) is None
    run["program"]["trace"] = None
    assert harness.reader("scan_device_ms_per_flush")(run) is None


def test_a_traced_run_on_the_cpu_reports_every_host_metric(tmp_path):
    """The stand-in cell at 20,000 rows, traced: every program metric that
    reads the host is finite, the program's flushes are the benchmark's
    spy's, and the spans inside each flush cover it. Each query's queue
    wait is found: the program's starts inside ``submit`` and ends as its
    flush begins, so it lies inside the benchmark's (from before the
    client built the query to the spy's call), short of it by the
    client's own work. An untraced run leaves the recorder off."""
    from repro_torch.utils import tracing

    base = tiny_base(tmp_path, rows=20000, warmup=32)
    cell = harness.benchmark()["workloads"][0]["name"]
    rec = traced_run.run(cell, 2 ** 31 + 91, 2.0, True, device="cpu",
                         base=base)
    assert rec["correct"] and not tracing.enabled()
    host = set(traced_run.PROGRAM_METRICS) - {
        "scan_device_ms_per_flush", "ingest_queue_wait_ms"}
    for m in host:
        v = rec["program_metrics"][m]
        assert v is not None and math.isfinite(v), m
    a = rec["agreement"]
    assert a["program_flushes"] == a["spy_flushes"] > 0
    assert a["program_queries_per_flush"] == a["spy_queries_per_flush"]
    assert a["queued_matched"] == rec["info"]["window"]["queries"]
    short = a["queue_wait_ms_matched"] - a["program_queued_ms_matched"]
    assert 0.0 <= short <= 2.0
    assert a["flush_uncovered_share"] <= 0.10
    untraced = traced_run.run(cell, 2 ** 31 + 91, 1.0, False, device="cpu",
                              base=base)
    assert "program_metrics" not in untraced and tracing.spans() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_span_on_another_thread_is_annotated_on_the_card(card):
    """Under ``profile_all_threads`` a span opened on a worker thread is a
    ``user_annotation`` on that thread, and the reduction gives it the
    device time of the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils import tracing

    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum().item()
    got = {}

    def worker():
        with tracing.span("service.flush"):
            with tracing.span("scan.block") as sp:
                got["id"] = sp.id
                (x * 3).sum()
            torch.cuda.synchronize()

    tracing.reset()
    tracing.enable()
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            t = threading.Thread(target=worker)
            t.start()
            t.join(60)
        assert not t.is_alive()
    finally:
        tracing.disable()
        tracing.reset()
    path = Path(tempfile.mkdtemp()) / "t.json"
    prof.export_chrome_trace(str(path))
    r = pt.reduce_annotated(str(path))
    assert r["flushes"] == 1 and r["span_device_s"].get(got["id"], 0) > 0
    assert r["in_span_device_s"] == pytest.approx(r["held_device_s"])
