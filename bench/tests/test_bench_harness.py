"""CPU tests of the benchmark harness (``bench/``): the traffic generator,
the reference against brute force, the roofline work counts, the metric
readers and the trace reduction on synthetic inputs, ``BENCHMARK.json``'s
names, the modules a run loads, and a cell added from files alone.

The whole-run tests use a tiny copy of each configuration (thousands of
rows, synopses of 300) on the CPU; the control and the planted faults are
in ``test_bench_correct.py``.
"""
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, querygen  # noqa: E402
from bench.reference import aqp as ref_aqp  # noqa: E402
from bench.roofline import peaks, work  # noqa: E402
from bench.trace import innermost, reduce_trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _config(name):
    return harness.load_json(ROOT / "bench" / "configs" / f"{name}.json")


def _mix(name):
    return harness.load_json(ROOT / "bench" / "traffic" / f"{name}.json")


def tiny_base(tmp: Path, rows: int = 30000, warmup: int = 16) -> Path:
    """A copy of ``bench/``'s data files, every configuration cut to
    ``rows`` rows and synopses of 300, every mix to 4 clients, a warm-up
    of ``warmup`` queries and a target of 10%: sizes a CPU test run
    holds."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, tmp / sub)
    for c in (tmp / "configs").glob("*.json"):
        d = json.loads(c.read_text())
        d["rows"] = rows
        d["engine"]["capacity"] = 300
        c.write_text(json.dumps(d))
    for t in (tmp / "traffic").glob("*.json"):
        d = json.loads(t.read_text())
        d.update(clients=4, target_rel_error=0.1)
        d["warmup"]["queries"] = warmup
        t.write_text(json.dumps(d))
    return tmp


# ------------------------------------------------------------------ traffic
@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_for_a_seed(mix):
    """Every run, whatever its seed, asks for the same queries in the same
    order; each client and the warm-up have their own."""
    m, sch = _mix(mix), _config("tpch_sf1")["schema"]

    def take(stream, n=50):
        return [stream.next() for _ in range(n)]

    a = take(querygen.client_streams(m, sch)[3])
    b = take(querygen.client_streams(m, sch)[3])
    c = take(querygen.client_streams(m, sch)[4])
    w = take(querygen.warmup_stream(m, sch), 16)
    assert a == b
    assert a != c and a[:16] != w
    n = m["pool"]["size"]  # the clients share the pool out, once round
    everyone = [q for s in querygen.client_streams(m, sch)
                for q in take(s, n // m["clients"])]
    assert len(set(map(repr, everyone))) == len(everyone) == n


def test_analysts_templates_match_their_parameters():
    m, sch = _mix("analysts"), _config("tpch_sf10")["schema"]
    s = querygen.client_streams(m, sch)[0]
    seen = set()
    for _ in range(600):
        q = s.next()
        seen.add(q.template)
        date = [r for r in q.ranges if r[0] == 0]
        assert len(date) == 1
        assert 0.0 <= date[0][1] <= 2157.0
        assert 90.0 <= date[0][2] - date[0][1] <= 400.0
        if q.template == "q6_revenue_window":
            assert q.aggs == (("SUM", 1),) and not q.groupby
            disc = [r for r in q.ranges if r[0] == 2][0]
            assert 0.0 <= disc[1] <= 0.06
            assert math.isclose(disc[2] - disc[1], 0.02)
            assert (1, 1.0, 24.0) in q.ranges
        elif q.template == "q1_price_by_returnflag":
            assert q.aggs == (("AVG", 0), ("COUNT", None))
            assert q.groupby == (0,)
        else:
            assert q.aggs == (("AVG", 1),)
            assert len(q.eqs) == 1 and q.eqs[0][0] == 2
            assert 0 <= q.eqs[0][1] < 25
    assert len(seen) == 3


def test_nation_report_template_matches_its_parameters():
    m, sch = _mix("nation_report"), _config("tpch_sf1")["schema"]
    s = querygen.client_streams(m, sch)[1]
    for _ in range(200):
        q = s.next()
        assert q.aggs == (("SUM", 1),) and q.groupby == (2,)
        (dim, lo, hi), = q.ranges
        assert dim == 0 and 0.0 <= lo <= 2192.0
        assert math.isclose(hi - lo, 365.0)


# ---------------------------------------------------------------- reference
def _relation(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    num = torch.stack([torch.rand(n, generator=g, dtype=torch.float64) * 2557,
                       1 + 49 * torch.rand(n, generator=g,
                                           dtype=torch.float64),
                       0.1 * torch.rand(n, generator=g,
                                        dtype=torch.float64)], 1)
    cat = torch.stack([torch.randint(0, k, (n,), generator=g)
                       for k in (3, 2, 25)], 1).to(torch.int32)
    meas = torch.randn(n, 2, generator=g, dtype=torch.float64) * 100 + 1000
    return {"num": num, "cat": cat, "measures": meas}


def test_reference_sample_is_the_ports_sample():
    from repro_torch.aqp.relation import Relation
    from repro_torch.aqp.sampler import build_sample
    from repro_torch.core.types import Schema

    cols = _relation(5003)
    sch = Schema((0.0, 1.0, 0.0), (2557.0, 50.0, 0.1), (3, 2, 25), 2)
    rel = Relation(sch, cols["num"], cols["cat"], cols["measures"])
    port = build_sample(rel, rate=0.1, n_batches=10, seed=2 ** 33 + 5)
    mine = ref_aqp.draw_sample(5003, 0.1, 10, 2 ** 33 + 5)
    assert len(mine) == port.n_batches
    for b, rows in enumerate(mine):
        got = port.relation.num[torch.as_tensor(port.batch_rows[b])]
        assert torch.equal(got, cols["num"][torch.as_tensor(rows)])


def test_reference_raw_estimates_match_brute_force():
    cols = _relation(4000)
    cfg = _config("tpch_sf1")
    cfg["rows"] = 4000
    ref = ref_aqp.AqpReference(cfg, cols, engine_seed=11)
    spec = querygen.QuerySpec("t", (("SUM", 1), ("AVG", 0), ("COUNT", None)),
                              ((0, 300.0, 1900.0), (1, 5.0, 40.0)),
                              ((1, 1),), (0,))
    dq = ref.decompose(spec)
    ids = sorted({sid for r in dq.rows for sid in r.values()})
    cum = ref.batch_partials(ids).numpy()
    num, cat = cols["num"].numpy(), cols["cat"].numpy()
    meas = cols["measures"].numpy()
    for g, r in enumerate(dq.rows):
        for (agg, m), sid in r.items():
            s = ref.snippets[sid]
            for b in (0, 4, 9):
                rows = np.concatenate(ref.batches[:b + 1])
                x = (num[rows] - ref.lo) / (ref.hi - ref.lo)
                ok = ((x >= s.lo - 1e-12) & (x <= s.hi + 1e-12)).all(1)
                for k in range(3):
                    ok &= s.cat[k][cat[rows, k]]
                v = meas[rows, s.measure][ok]
                want = [ok.sum(), v.sum(), (v * v).sum()]
                np.testing.assert_allclose(cum[b, ids.index(sid)], want,
                                           rtol=1e-12)
                theta, beta2 = ref.estimates(cum[b, [ids.index(sid)]],
                                             [agg], len(rows))
                n = len(rows)
                if agg == "FREQ":
                    p = ok.sum() / n
                    np.testing.assert_allclose(theta, [p], rtol=1e-12)
                    np.testing.assert_allclose(beta2, [p * (1 - p) / n],
                                               rtol=1e-12)
                elif len(v) >= 2:
                    np.testing.assert_allclose(theta, [v.mean()], rtol=1e-12)
                    np.testing.assert_allclose(
                        beta2, [v.var() / len(v)], rtol=1e-9)
    assert dq.groups == [(0,), (1,), (2,)]


def test_reference_synopsis_keeps_capacity_by_recency():
    s = ref_aqp.Synopsis(3)
    s.record([1, 2, 3], [1.0, 2.0, 3.0], [0.5, 0.5, 0.5])
    s.record([1, 4], [1.5, 4.0], [0.1, 0.5])  # 1 refreshed, 2 evicted
    assert sorted(s.entries) == [1, 3, 4]
    assert s.entries[1].theta == 1.5 and s.entries[1].beta2 == 0.1
    s.record([1], [9.0], [0.9])  # a worse repeat keeps the better answer
    assert s.entries[1].theta == 1.5
    s.record([5, 6], [5.0, 6.0], [0.5, np.inf])  # non-finite is skipped
    assert sorted(s.entries) == [1, 4, 5]


# ----------------------------------------------------------------- roofline
def test_roofline_work_hand_counted():
    assert work.scan(t=2, q=3, l=1, c=1, v=2, m=1) == (166, 54, "float64")
    assert work.covariance(n_i=2, n_j=3, l=1, gram=False) == (
        184, 264, "float64_simt")
    assert work.covariance(n_i=3, n_j=3, l=1, gram=True) == (
        160, 288, "float64_simt")
    assert peaks.least_seconds(3.35e12, 0.0, "float64") == 1.0
    assert peaks.least_seconds(0.0, 34e12, "float64_simt") == 1.0


# ---------------------------------------------------------- readers, traces
def _synthetic_run():
    queries = [{"submit": 0.0, "resolve": 1.0, "latency_s": 1.0,
                "in_window": True, "failed": False, "start": 0.25,
                "end": 1.0, "batches_used": 2},
               {"submit": 0.5, "resolve": 3.5, "latency_s": 3.0,
                "in_window": True, "failed": False, "start": 1.5,
                "end": 2.5, "batches_used": 4},
               {"submit": 9.0, "resolve": 11.0, "latency_s": 2.0,
                "in_window": False, "failed": False, "start": 9.5,
                "batches_used": 10}]
    spans = [("flush", 0, 10.25, 11.0, 1, {"queries": 1}),
             ("scan", 1, 10.3, 10.4, 1, dict(t=100, q=128, l=3, c=3, v=25,
                                             m=2)),
             ("improve", 2, 10.4, 10.6, 1, {}),
             ("record", 3, 10.6, 10.65, 1, {}),
             ("ingest", 4, 10.7, 10.9, 2, {}),
             ("cov", 5, 10.75, 10.8, 2, dict(n_i=8, n_j=64, l=3,
                                             gram=False)),
             ("flush", 6, 11.5, 13.5, 3, {"queries": 1}),
             ("flush", 7, 19.5, 20.5, 3, {"queries": 5})]  # past the phase
    least = peaks.least_seconds(*work.scan(100, 128, 3, 3, 25, 2))
    flushes = [(0.25, 1.0, 1), (1.5, 3.5, 3), (9.5, 11.0, 5)]
    return {"window": (0.0, 10.0), "window_s": 10.0, "traced": (10.0, 20.0),
            "queries": queries, "flushes": flushes,
            "setup_s": 12.5, "counters": {"flushes": 2, "launches": 30},
            "spans": spans,
            "trace": {"busy_s": 1.0, "window_s": 4.0,
                      "span_device_s": {1: least * 4, 5: 1e-3}}}, least


def test_metric_readers_on_a_synthetic_span_log():
    run, least = _synthetic_run()
    got = {f.stem: harness.reader(f.stem)(run)
           for f in (ROOT / "bench" / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
            } <= set(got)
    assert got["qps"] == 0.2
    assert got["latency_p50_ms.host_paced"] == pytest.approx(2000.0)
    assert got["latency_p90_ms.host_paced"] == pytest.approx(2800.0)
    assert got["setup_s"] == 12.5
    assert got["flush_queries_mean"] == 2.0
    assert got["resolve_wait_ms"] == pytest.approx(500.0)
    assert got["queue_wait_ms"] == pytest.approx(625.0)
    assert got["host_ms_per_query"] == pytest.approx(
        1e3 * ((0.75 - 0.35) + 2.0) / 2)
    assert got["launches_per_query"] == 15.0
    assert got["scan_ms_per_flush"] == pytest.approx(50.0)
    assert got["improve_ms_per_query"] == pytest.approx(100.0)
    assert got["ingest_ms_per_apply"] == pytest.approx(200.0)
    assert got["batches_used_mean"] == 3.0
    assert got["scan_roofline"] == pytest.approx(25.0)
    cov = peaks.least_seconds(*work.covariance(8, 64, 3, False))
    assert got["covariance_roofline"] == pytest.approx(100 * cov / 1e-3)
    assert got["device_idle_share"] == pytest.approx(75.0)
    run["trace"] = None
    run["spans"] = None
    for name in ("scan_roofline", "covariance_roofline", "device_idle_share",
                 "host_ms_per_query", "scan_ms_per_flush"):
        assert harness.reader(name)(run) is None


def test_trace_reduction_gives_device_time_to_the_launching_span():
    off = 7.0e11  # the trace's clock, far from the host's
    ev = []

    def launch(ts, tid, corr, name, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": ts + off, "dur": 2, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name,
                   "ts": ts + off + 10, "dur": dur, "tid": 7,
                   "args": {"correlation": corr}})

    launch(1.0e6, 99, 1, "spin_kernel(long)", 3)
    launch(3.0e6, 99, 2, "spin_kernel(long)", 3)
    launch(1.41e6, 555, 3, "spin_kernel(long)", 1)  # the threads' tags
    launch(1.46e6, 666, 4, "spin_kernel(long)", 1)
    for i in range(5):  # the flush thread's scans
        launch(1.50e6 + i * 1e3, 555, 10 + i, "fms_partials", 40)
    for i in range(3):  # the ingest thread's covariance builds
        launch(1.58e6 + i * 1e3, 666, 20 + i, "se_cov", 20)
    spans = [("flush", 0, 1.4, 1.8, 111, {}), ("scan", 1, 1.49, 1.51, 111, {}),
             ("ingest", 2, 1.45, 1.7, 222, {}),
             ("cov", 3, 1.575, 1.59, 222, {})]
    path = Path(tempfile.mkdtemp()) / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = reduce_trace(str(path), 2.0, spans,
                     [(0.999999, 1.000001), (2.999999, 3.000001)],
                     [(1.409999, 1.410001, 111), (1.459999, 1.460001, 222)])
    assert r["span_device_s"][1] == pytest.approx(5 * 40e-6)
    assert r["span_device_s"][3] == pytest.approx(3 * 20e-6)
    assert r["busy_s"] == pytest.approx(5 * 40e-6 + 3 * 20e-6)
    assert [n for n, _ in r["device_ops"]] == ["fms_partials", "se_cov"]
    assert abs(r["clock_drift_us"]) < 1.0
    assert innermost([(0, 10), (2, 5)], [3, 7, 11]) == [(2, 5), (0, 10),
                                                        None]


# --------------------------------------------------------- BENCHMARK.json
def test_benchmark_names_units_and_files():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in [e["name"] for e in b["end_to_end"]]
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 0, "repro_torch.core": 0, "repro.core": 0,
            "jaxlib": 0, "jax_like": 0, "flax.linen": 0, "reproduce": 0}
    assert harness.forbidden_modules(mods) == ["flax.linen", "jaxlib",
                                               "repro.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    base = tiny_base(tmp_path)
    cell = BENCH["workloads"][0]["name"]
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness\n"
        f"line = harness.run({cell!r}, 5, 1.0, False, device='cpu', "
        f"base=__import__('pathlib').Path({str(base)!r}))\n"
        "print(json.dumps([harness.forbidden_modules(), "
        "'repro_torch' in sys.modules, line['attempted']]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    found, port, attempted = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and port and attempted > 0


def test_a_cell_added_from_files_alone(tmp_path):
    base = tiny_base(tmp_path)
    cfg = json.loads((base / "configs" / "tpch_sf1.json").read_text())
    cfg["rows"] = 20000
    (base / "configs" / "tpch_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "analysts.json").read_text())
    mix["templates"] = [mix["templates"][0]]
    (base / "traffic" / "q6_only.json").write_text(json.dumps(mix))
    (base / "metrics" / "queries_done.py").write_text(
        "def read(run):\n"
        "    return float(sum(q['in_window'] for q in run['queries']))\n")
    (base / "limits" / "tpch_tiny.q6_only.json").write_text(
        (base / "limits" / f"{BENCH['workloads'][0]['name']}.json")
        .read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tpch_tiny", "source": "test",
                             "file": "bench/configs/tpch_tiny.json",
                             "reduced": ["rows"], "why": "test"})
    bench["workloads"].append({"name": "tpch_tiny.q6_only",
                               "config": "tpch_tiny", "traffic": "q6_only",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "queries_done", "unit": "queries",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tpch_tiny.q6_only"]})
    line = harness.run("tpch_tiny.q6_only", 21, 1.0, False, device="cpu",
                       bench=bench, base=base)
    assert line["metrics"]["queries_done"]["value"] == line["attempted"] > 0
    assert {"qps", "setup_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks" and "stop_ratio" in line["checks"]
