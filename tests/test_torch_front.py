"""The port's multi-tenant serving front (``repro_torch.serving.front``:
admission, metrics, the JSON wire codec, ``ServingFront``, the HTTP/NDJSON
transport) against the JAX reference's ``repro.serving.front`` (CPU).

Every test of ``test_serving_front.py`` runs here as a scenario on both
packages, over that file's relation (3,000 rows, two numeric dims, one
categorical dim of 4 values, one measure; ``sample_rate=0.2``,
``n_batches=4``, ``capacity=128``), each with the reference test's own
assertions. Then the two packages' records must agree:
  - admission decisions, ``retry_after_s``, ``Rejection`` fields and
    histogram snapshots for the same durations on one scripted clock:
    exactly;
  - lowered queries equal, ``WireError`` messages equal;
  - ``answer_to_json`` of both packages' answers: every integer, flag and
    string exact, cells' groups exact, estimates and beta² within rtol
    1e-11 (the tight float64 tolerance of the parity policy, which the
    engines meet at this size);
  - per-tenant stats: the same keys, the same counters.
Inside the port the miss path is bitwise a direct ``Session.execute``.

The reference runs with ``async_ingest=False``: its router reads
``Synopsis.n``, which races its ingest thread (ROADMAP Queue 3); the port
runs with its default asynchronous ingest.

The HTTP tests run on the port alone, bound to ``127.0.0.1`` on an
ephemeral port: the execute round trip bitwise, the NDJSON stream's final
line bitwise ``execute``, the 429 / 503 / 400 / 404 mapping, stats,
healthz and concurrent tenants.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving.front as jfront  # noqa: E402
import repro.verdict as jvd  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.verdict.answer import FailedAnswer as JxFailed  # noqa: E402
from repro.verdict.answer import QueryAnswer as JxAnswer  # noqa: E402
import repro_torch.serving.front as pfront  # noqa: E402
import repro_torch.verdict as pvd  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.verdict.answer import FailedAnswer as PtFailed  # noqa: E402
from repro_torch.verdict.answer import QueryAnswer as PtAnswer  # noqa: E402

REL_KW = dict(seed=0, n_rows=3_000, n_num=2, cat_sizes=(4,), n_measures=1,
              lengthscale=0.4, noise=0.2)
RTOL = 1e-11

JAX = types.SimpleNamespace(
    name="jax", vd=jvd, F=jfront, W=jx_w, Answer=JxAnswer, Failed=JxFailed,
    cfg=dict(async_ingest=False), rel_kw={})
PORT = types.SimpleNamespace(
    name="torch", vd=pvd, F=pfront, W=pt_w, Answer=PtAnswer, Failed=PtFailed,
    cfg={}, rel_kw=dict(device="cpu"))
LIBS = (JAX, PORT)
BOTH = pytest.mark.parametrize("L", LIBS, ids=lambda L: L.name)


@pytest.fixture(scope="module")
def rels():
    return {L.name: L.W.make_relation(**REL_KW, **L.rel_kw) for L in LIBS}


def _cfg(L, **kw):
    base = dict(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
    base.update(L.cfg)
    base.update(kw)
    return L.vd.EngineConfig(**base)


def _cells(ans):
    return [c.to_dict() for c in ans.cells]


QJ = {"aggs": [{"kind": "avg", "measure": "v0"}],
      "where": [{"op": "between", "column": "x0", "lo": 2.0, "hi": 8.0}]}
QJ_SUM = {"aggs": [{"kind": "sum", "measure": "v0"}],
          "where": [{"op": "between", "column": "x1", "lo": 1.0, "hi": 6.0}]}


class FakeClock:
    """Scripted monotonic clock: admission replay's time source."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ------------------------------------------------------------- records


def _same_wire(got, want):
    """The port's ``answer_to_json`` objects against the reference's
    (module docstring)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), i
        assert ({k: v for k, v in a.items() if k != "cells"}
                == {k: v for k, v in b.items() if k != "cells"}), i
        ca, cb = a.get("cells", []), b.get("cells", [])
        assert ([(c["group"], c["agg"], c["kind"]) for c in ca]
                == [(c["group"], c["agg"], c["kind"]) for c in cb]), i
        for x, y in zip(ca, cb):
            assert type(x["estimate"]) is float and type(x["beta2"]) is float
            for f in ("estimate", "beta2"):
                np.testing.assert_allclose(x[f], y[f], rtol=RTOL, atol=0,
                                           err_msg=f"answer {i} {f}")


def _wire(L, answers):
    """Each answer through its package's codec and a JSON round trip."""
    return [json.loads(json.dumps(L.F.answer_to_json(a))) for a in answers]


def _parity_wire(scenario, rels, *args):
    """Run ``scenario(L, relation, *args)`` on both packages (it returns
    answers) and hold the port's wire objects to the reference's."""
    rec = {L.name: _wire(L, scenario(L, rels[L.name], *args)) for L in LIBS}
    _same_wire(rec["torch"], rec["jax"])
    return rec


def _keys(obj):
    """The nested key structure of a stats block."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def _ir(obj):
    """A package-free form of a lowered query (dataclasses by class name)."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _ir(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return tuple(_ir(x) for x in obj)
    if isinstance(obj, (np.generic,)):
        return obj.item()
    return obj


# ----------------------------------------------------------- admission unit


@BOTH
def test_token_bucket_is_a_pure_function_of_now(L):
    b = L.F.TokenBucket(rate=2.0, burst=3, now=0.0)
    takes = [b.try_take(0.0) for _ in range(4)]
    assert takes == [True, True, True, False]
    assert b.retry_after(0.0) == pytest.approx(0.5)
    assert not b.try_take(0.4)
    assert b.try_take(0.5)
    assert not b.try_take(0.1)


def test_admission_replays_exactly_from_a_scripted_clock():
    """Both packages on one scripted clock: the same decisions and the same
    ``retry_after_s`` / ``Rejection`` fields, exactly."""
    rng = np.random.default_rng(0)
    script = np.cumsum(rng.exponential(0.3, size=60)).tolist()
    depths = rng.integers(0, 10, size=60).tolist()
    script[:6] = [0.0, 0.01, 0.02, 0.6, 0.61, 1.4]
    depths[:6] = [0] * 6

    def run(L):
        ctl = L.F.AdmissionController(
            "t", L.F.AdmissionConfig(rate=2.0, burst=2, max_pending=8),
            now=0.0)
        out = []
        for now, depth in zip(script, depths):
            rej = ctl.admit(now, queue_depth=depth)
            out.append(None if rej is None else dataclasses.asdict(rej))
        return out, ctl.stats()

    first, second = run(PORT), run(PORT)
    assert first == second
    decisions = [r is None for r in first[0][:6]]
    assert decisions == [True, True, False, True, False, True]
    assert run(JAX) == first
    assert {r["reason"] for r in first[0] if r} == {"rate_limit",
                                                    "queue_full"}


@BOTH
def test_queue_full_rejection_is_typed_with_retry_hint(L):
    ctl = L.F.AdmissionController("t", L.F.AdmissionConfig(
        rate=10.0, burst=5, max_pending=3))
    rej = ctl.admit(0.0, queue_depth=3)
    assert isinstance(rej, L.F.Rejection) and rej.rejected and not rej.failed
    assert rej.reason == "queue_full" and rej.status == 503
    assert rej.retry_after_s == pytest.approx(0.1)
    assert ctl.stats()["rejected_queue_full"] == 1
    assert ctl.admit(0.0, queue_depth=2) is None


@BOTH
def test_rate_limit_rejection_is_typed(L):
    ctl = L.F.AdmissionController("t", L.F.AdmissionConfig(
        rate=1.0, burst=1, max_pending=8))
    assert ctl.admit(0.0, queue_depth=0) is None
    rej = ctl.admit(0.0, queue_depth=0)
    assert isinstance(rej, L.F.Rejection)
    assert rej.reason == "rate_limit" and rej.status == 429
    assert rej.retry_after_s == pytest.approx(1.0)
    st = ctl.stats()
    assert st["admitted"] == 1 and st["rejected_rate_limit"] == 1
    other = JAX if L is PORT else PORT
    twin = other.F.AdmissionController("t", other.F.AdmissionConfig(
        rate=1.0, burst=1, max_pending=8))
    twin.admit(0.0, queue_depth=0)
    assert (dataclasses.asdict(twin.admit(0.0, queue_depth=0))
            == dataclasses.asdict(rej))
    assert str(rej) == str(twin.admit(0.0, queue_depth=0))


def test_latency_histogram_quantiles():
    snaps = []
    for L in LIBS:
        h = L.F.LatencyHistogram()
        for ms in (1, 1, 2, 2, 4, 8, 1000):
            h.record(ms / 1e3)
        snap = h.snapshot()
        assert snap["count"] == 7
        assert snap["max_s"] == pytest.approx(1.0)
        assert 0.0005 <= snap["p50_s"] <= 0.004
        assert snap["p99_s"] >= 0.5
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    # The same durations from a seed, with the edges (0, negative, past the
    # last bucket): the same counts and snapshots in both packages.
    rng = np.random.default_rng(1)
    durations = (list(10.0 ** rng.uniform(-7, 3.5, size=500))
                 + [0.0, -1.0, 2.0 ** -20, 2.0 ** 19, 1e9])
    got = []
    for L in LIBS:
        m = L.F.TenantMetrics("t")
        for i, d in enumerate(durations):
            m.record_outcome(types.SimpleNamespace(failed=False,
                                                   degraded=i % 7 == 0),
                             d, op="execute" if i % 3 else "explain",
                             prescreened=i % 5 == 0)
        m.record_rejection(types.SimpleNamespace(reason="rate_limit"))
        m.record_stream(4, 0.25)
        got.append(m.snapshot())
    assert got[0] == got[1]


# ------------------------------------------------------------------ tenancy


def _shared_tenants_share_learned_state(L, rel):
    front = L.F.ServingFront(rel, _cfg(L))
    front.add_tenant(L.F.TenantSpec("a", isolation="shared"))
    front.add_tenant(L.F.TenantSpec("b", isolation="shared"))
    front.add_tenant(L.F.TenantSpec("iso", isolation="isolated"))
    a, b, iso = (front.tenant(n) for n in ("a", "b", "iso"))
    assert a.session.engine is b.session.engine
    assert a.session.store is b.session.store
    assert iso.session.engine is not a.session.engine
    q = L.F.query_from_json(a.session.schema, QJ)
    first = front.execute("a", q)
    second = front.execute("b", q)
    assert second.served_from == "cache:exact"
    assert _cells(second) == _cells(first)
    third = front.execute("iso", q)
    assert third.served_from is None
    per_tenant = front.stats()["shared_intel"]["per_tenant"]
    assert per_tenant["a"]["hits"] == 0 and per_tenant["b"]["hits"] == 1
    for t in (a, iso):
        t.session.drain()
    return [first, second, third]


def test_shared_tenants_share_learned_state(rels):
    _parity_wire(_shared_tenants_share_learned_state, rels)


@BOTH
def test_shared_services_share_one_engine_lock(L, rels):
    front = L.F.ServingFront(rels[L.name], _cfg(L))
    front.add_tenant("a")
    front.add_tenant("b")
    front.add_tenant(L.F.TenantSpec("iso", isolation="isolated"))
    a, b, iso = (front.tenant(n) for n in ("a", "b", "iso"))
    assert a.service._exec_lock is b.service._exec_lock
    assert iso.service._exec_lock is not a.service._exec_lock


def _miss_path(L, rel):
    front = L.F.ServingFront(rel, _cfg(L))
    front.add_tenant(L.F.TenantSpec("t", isolation="isolated"))
    direct = L.vd.connect(rel, _cfg(L))
    qs = L.W.make_workload(7, rel.schema, 4,
                           agg_kinds=("AVG", "COUNT", "SUM"))
    out = []
    for q in qs:
        a = front.execute("t", q)
        b = direct.execute(q)
        assert isinstance(a, L.Answer) and not a.failed
        assert _cells(a) == _cells(b)  # bitwise, inside each package
        assert a.batches_used == b.batches_used
        out.append(a)
    front.tenant("t").session.drain()
    direct.drain()
    return out


def test_miss_path_bitwise_equal_to_direct_session(rels):
    """The tentpole parity gate: through admission + microbatch service, a
    fresh tenant's answer is bitwise a direct Session.execute in each
    package, and the port's wire answers match the reference's."""
    _parity_wire(_miss_path, rels)


@BOTH
def test_duplicate_and_unknown_tenants(L, rels):
    front = L.F.ServingFront(rels[L.name], _cfg(L))
    front.add_tenant("a")
    with pytest.raises(ValueError, match="already registered"):
        front.add_tenant("a")
    with pytest.raises(KeyError, match="unknown tenant"):
        front.execute("ghost", None)
    with pytest.raises(ValueError, match="isolation"):
        L.F.TenantSpec("x", isolation="galactic")


def _rejections(L, rel):
    clock = FakeClock()
    front = L.F.ServingFront(rel, _cfg(L), clock=clock)
    front.add_tenant(L.F.TenantSpec("t", rate=1.0, burst=1, max_pending=8))
    q = L.F.query_from_json(front.tenant("t").session.schema, QJ)
    first = front.execute("t", q)
    assert isinstance(first, L.Answer)
    rej = front.execute("t", q)
    assert isinstance(rej, L.F.Rejection) and rej.reason == "rate_limit"
    clock.advance(1.5)
    again = front.execute("t", q)
    assert not getattr(again, "rejected", False)
    st = front.stats("t")
    assert st["admission"]["admitted"] == 2
    assert st["admission"]["rejected_rate_limit"] == 1
    assert st["metrics"]["rejected"] == {"rate_limit": 1}
    front.tenant("t").session.drain()
    return [first, rej, again]


def test_front_rejections_are_values_and_counted(rels):
    _parity_wire(_rejections, rels)


def _stream(L, rel):
    front = L.F.ServingFront(rel, _cfg(L), cache=False)
    front.add_tenant(L.F.TenantSpec("t", isolation="isolated"))
    q = L.F.query_from_json(front.tenant("t").session.schema, QJ)
    rounds = list(front.stream("t", q))
    assert len(rounds) == 4
    assert [r.final for r in rounds] == [False, False, False, True]
    twin = L.vd.connect(rel, _cfg(L))
    assert _cells(rounds[-1]) == _cells(twin.execute(q))
    st = front.stats("t")["metrics"]
    assert st["streams"] == 1 and st["stream_rounds"] == 4
    twin.drain()
    return rounds


def test_stream_yields_refinements_and_final_matches_execute(rels):
    _parity_wire(_stream, rels)


def test_per_tenant_stats_schema(rels):
    blocks = {}
    for L in LIBS:
        front = L.F.ServingFront(rels[L.name], _cfg(L))
        front.add_tenant("t")
        front.add_tenant(L.F.TenantSpec("iso", isolation="isolated"))
        q = L.F.query_from_json(front.tenant("t").session.schema, QJ)
        front.execute("t", q)
        st = front.stats("t")
        assert st["isolation"] == "shared"
        assert {"admitted", "rejected_rate_limit", "rejected_queue_full",
                "rate", "burst", "max_pending"} <= set(st["admission"])
        m = st["metrics"]
        assert m["requests"] == 1 and m["answered"] == 1
        assert m["failed"] == 0 and m["degraded"] == 0
        assert "execute" in m["latency"]
        assert {"count", "mean_s", "p50_s", "p90_s", "p99_s",
                "max_s"} <= set(m["latency"]["execute"])
        assert st["service"]["flushes"] == 1
        assert st["health"]["quarantined"] == {}
        front.tenant("t").session.drain()
        blocks[L.name] = (st, front.stats())
    (pt, pt_all), (jx, jx_all) = blocks["torch"], blocks["jax"]
    assert _keys(pt) == _keys(jx)
    assert _keys(pt_all["tenants"]) == _keys(jx_all["tenants"])
    assert set(pt_all) == set(jx_all)
    for block in ("admission", "service", "health"):
        assert pt[block] == jx[block], block
    counters = ("tenant", "requests", "answered", "degraded", "failed",
                "rejected", "prescreen_hits", "streams", "stream_rounds")
    assert ([pt["metrics"][k] for k in counters]
            == [jx["metrics"][k] for k in counters])
    intel = ("lookups", "hits", "misses", "per_tenant")
    assert ({k: pt_all["shared_intel"][k] for k in intel}
            == {k: jx_all["shared_intel"][k] for k in intel})


# --------------------------------------------------------------- wire codec


@BOTH
def test_wire_query_lowers_through_the_builder(L, rels):
    s = L.vd.connect(rels[L.name], _cfg(L))
    wire_q = L.F.query_from_json(s.schema, {
        "aggs": [{"kind": "avg", "measure": "v0"}, {"kind": "count"}],
        "where": [{"op": "between", "column": "x0", "lo": 2, "hi": 8},
                  {"op": "equals", "column": "c0", "value": 1},
                  {"op": "one_of", "column": "c0", "values": [0, 1]}],
        "group_by": ["c0"],
    })
    built = (s.query().avg("v0").count()
             .where(L.vd.between("x0", 2, 8), L.vd.equals("c0", 1),
                    L.vd.one_of("c0", [0, 1]))
             .group_by("c0"))
    assert wire_q.build() == built.build()


def test_wire_queries_lower_alike_in_both_packages(rels):
    """The same query JSON lowers to the same engine query in both."""
    qjs = [QJ, QJ_SUM, {
        "aggs": [{"kind": "avg", "measure": "v0"}, {"kind": "count"},
                 {"kind": "sum", "measure": "v0"},
                 {"kind": "max", "measure": "v0"}],
        "where": [{"op": "between", "column": "x0", "lo": 2, "hi": 8},
                  {"op": "between", "column": "x1", "lo": -1.5, "hi": 3},
                  {"op": "equals", "column": "c0", "value": 1},
                  {"op": "one_of", "column": "c0", "values": [0, 2, 3]}],
        "group_by": ["c0"]}]
    lowered = {L.name: [_ir(L.F.query_from_json(rels[L.name].schema, qj)
                            .build()) for qj in qjs] for L in LIBS}
    assert lowered["torch"] == lowered["jax"]


WIRE_ERRORS = [
    ({"aggs": []}, "non-empty"),
    ({"aggs": [{"kind": "median", "measure": "v0"}]}, "unknown aggregate"),
    ({"aggs": [{"kind": "avg"}]}, "needs a"),
    ({"aggs": [{"kind": "avg", "measure": "nope"}]}, "malformed query"),
    ({"aggs": [{"kind": "count"}],
      "where": [{"op": "like", "column": "x0"}]}, "unknown predicate"),
    ([1, 2], "JSON object"),
]


@pytest.mark.parametrize("bad,msg", WIRE_ERRORS)
def test_wire_query_errors_are_typed(rels, bad, msg):
    errors = []
    for L in LIBS:
        with pytest.raises(L.F.WireError, match=msg) as e:
            L.F.query_from_json(rels[L.name].schema, bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@BOTH
def test_wire_budget_roundtrip(L):
    b = L.F.budget_from_json({"target_rel_error": 0.1, "max_batches": 2,
                              "delta": 0.9, "deadline_s": 1.5})
    assert b == L.vd.ErrorBudget(0.1, 2, 0.9, 1.5)
    assert L.F.budget_from_json(None) is None
    with pytest.raises(L.F.WireError, match="unknown budget keys"):
        L.F.budget_from_json({"deadline": 1.0})


def test_wire_budget_errors_match():
    for bad in ({"deadline": 1.0}, {"max_batches": "many"}, [0.1]):
        msgs = []
        for L in LIBS:
            with pytest.raises(L.F.WireError) as e:
                L.F.budget_from_json(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], bad


@BOTH
def test_wire_answer_ladder_discriminated(L):
    failed = L.Failed(error="boom", error_type="InjectedFault", attempts=3)
    rej = L.F.Rejection("rate_limit", "t", 0.25)
    assert L.F.answer_to_json(failed)["kind"] == "failed"
    assert L.F.answer_to_json(failed)["attempts"] == 3
    r = L.F.answer_to_json(rej)
    assert r["kind"] == "rejected" and r["retry_after_s"] == 0.25
    with pytest.raises(TypeError):
        L.F.answer_to_json(object())
    other = JAX if L is PORT else PORT
    assert r == other.F.answer_to_json(other.F.Rejection("rate_limit", "t",
                                                         0.25))


def test_wire_emits_plain_python_numbers():
    """Numbers that reach the codec as numpy scalars or 0-d tensors leave
    it as Python ints and floats, the floats bit for bit."""
    est = np.float64(1.0) / 3.0
    cell = pvd.Cell(group=(np.int64(2),), agg=np.int64(0), kind="SUM",
                    estimate=torch.tensor(est, dtype=torch.float64),
                    beta2=np.float64(2.0 ** -40))
    ans = PtAnswer(cells=(cell,), batches_used=np.int64(3),
                   tuples_scanned=torch.tensor(600), supported=np.bool_(True))
    obj = json.loads(json.dumps(pfront.answer_to_json(ans)))
    c = obj["cells"][0]
    assert c == {"group": [2], "agg": 0, "kind": "SUM", "estimate": est,
                 "beta2": 2.0 ** -40}
    assert type(c["estimate"]) is float and c["estimate"] == float(est)
    assert obj["batches_used"] == 3 and obj["tuples_scanned"] == 600
    assert obj["supported"] is True
    report = pvd.PlanReport(True, None, np.int64(1), 1, 0, 1, 1,
                            np.float64(1.5), {(0, 0): np.int64(8)},
                            {(0, 0): torch.tensor(0)}, {(0, 0): "local"})
    obj = json.loads(json.dumps(pfront.report_to_json(report)))
    assert obj["q_buckets"] == {"(0, 0)": 8}
    assert obj["fill_buckets"] == {"(0, 0)": 0}
    assert obj["dedup_ratio"] == 1.5 and obj["n_cells"] == 1


def _explain(L, rel):
    front = L.F.ServingFront(rel, _cfg(L))
    front.add_tenant("t")
    q = L.F.query_from_json(front.tenant("t").session.schema, QJ)
    before = json.loads(json.dumps(L.F.report_to_json(front.explain("t", q))))
    front.execute("t", q)
    front.tenant("t").session.drain()
    after = json.loads(json.dumps(L.F.report_to_json(front.explain("t", q))))
    return before, after


def test_wire_plan_reports_match(rels):
    got = {L.name: _explain(L, rels[L.name]) for L in LIBS}
    for pt, jx in zip(got["torch"], got["jax"]):
        pt = dict(pt, scan_evaluator=None)
        jx = dict(jx, scan_evaluator=None)
        assert pt == jx
    assert got["torch"][1]["cache"] == "exact"


# ----------------------------------------------------------- HTTP transport


@pytest.fixture(scope="module")
def http_front(rels):
    front = pfront.ServingFront(rels["torch"], _cfg(PORT))
    front.add_tenant(pfront.TenantSpec("web", isolation="shared"))
    front.add_tenant(pfront.TenantSpec("etl", isolation="isolated"))
    front.add_tenant(pfront.TenantSpec("tiny", rate=0.001, burst=1,
                                       max_pending=8))
    front.add_tenant(pfront.TenantSpec("full", max_pending=0))
    server = pfront.serve_http(front)
    host, port = server.server_address
    yield front, f"http://{host}:{port}"
    server.shutdown()
    server.server_close()


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wire_cells(body):
    return [dict(c, group=tuple(c["group"])) for c in body["cells"]]


def test_http_execute_roundtrip_bitwise(http_front, rels):
    _, base = http_front
    status, body, _ = _post(base, "/v1/tenants/web/execute", {"query": QJ})
    assert status == 200 and body["kind"] == "answer"
    twin = pvd.connect(rels["torch"], _cfg(PORT))
    direct = twin.execute(pfront.query_from_json(twin.schema, QJ))
    assert _wire_cells(body) == _cells(direct)  # float64 bits survive JSON
    assert body == json.loads(json.dumps(pfront.answer_to_json(direct)))
    twin.drain()


def test_http_explain(http_front):
    _, base = http_front
    status, body, _ = _post(base, "/v1/tenants/web/explain", {"query": QJ})
    assert status == 200 and body["kind"] == "plan"
    assert body["supported"] is True and body["n_snippets"] > 0


def test_http_stream_ndjson(http_front, rels):
    _, base = http_front
    budget = {"target_rel_error": 0.05}
    req = urllib.request.Request(
        base + "/v1/tenants/etl/stream",
        data=json.dumps({"query": QJ_SUM, "budget": budget}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/x-ndjson"
        assert r.headers["Transfer-Encoding"] == "chunked"
        rounds = [json.loads(line) for line in r]
    assert 1 <= len(rounds) <= 4
    assert [x["final"] for x in rounds] == [False] * (len(rounds) - 1) + [True]
    assert all(x["kind"] == "answer" for x in rounds)
    twin = pvd.connect(rels["torch"], _cfg(PORT))
    want = twin.execute(pfront.query_from_json(twin.schema, QJ_SUM),
                        pfront.budget_from_json(budget))
    assert rounds[-1] == json.loads(json.dumps(pfront.answer_to_json(want)))
    twin.drain()


def test_http_admission_rejection_statuses(http_front):
    _, base = http_front
    st1, _, _ = _post(base, "/v1/tenants/tiny/execute", {"query": QJ})
    assert st1 == 200
    st2, body, headers = _post(base, "/v1/tenants/tiny/execute",
                               {"query": QJ})
    assert st2 == 429 and body["kind"] == "rejected"
    assert body["reason"] == "rate_limit"
    assert float(headers["Retry-After"]) > 0
    st3, body, headers = _post(base, "/v1/tenants/full/execute",
                               {"query": QJ})
    assert st3 == 503 and body["reason"] == "queue_full"
    assert float(headers["Retry-After"]) > 0


def test_http_error_mapping(http_front):
    _, base = http_front
    st, body, _ = _post(base, "/v1/tenants/ghost/execute", {"query": QJ})
    assert st == 404 and body["kind"] == "error"
    st, body, _ = _post(base, "/v1/tenants/web/execute",
                        {"query": {"aggs": []}})
    assert st == 400 and "non-empty" in body["error"]
    st, body, _ = _post(base, "/v1/tenants/web/execute", {"query": QJ,
                        "budget": {"deadline": 1}})
    assert st == 400 and "unknown budget keys" in body["error"]
    req = urllib.request.Request(base + "/v1/tenants/web/execute",
                                 data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=120)
    assert e.value.code == 400
    assert "invalid JSON body" in json.loads(e.value.read())["error"]
    st, body = _get(base, "/v1/nope")
    assert st == 404
    st, body, _ = _post(base, "/v1/tenants/web/delete", {"query": QJ})
    assert st == 404


def test_http_stats_and_healthz(http_front):
    _, base = http_front
    st, body = _get(base, "/v1/healthz")
    assert st == 200 and body == {"ok": True}
    st, body = _get(base, "/v1/tenants/web/stats")
    assert st == 200 and body["metrics"]["tenant"] == "web"
    st, body = _get(base, "/v1/stats")
    assert st == 200 and "web" in body["tenants"]
    assert body["shared_intel"]["enabled"] is True
    st, body = _get(base, "/v1/tenants/ghost/stats")
    assert st == 404


def test_http_concurrent_tenants_all_resolve(http_front):
    """Concurrent HTTP clients across shared and isolated tenants: every
    request gets a typed body, never a hung socket or a 500."""
    front, base = http_front
    for name in ("c1", "c2"):
        front.add_tenant(pfront.TenantSpec(name, isolation="shared"))
    front.add_tenant(pfront.TenantSpec("c3", isolation="isolated"))
    results = []

    def client(name):
        status, body, _ = _post(base, f"/v1/tenants/{name}/execute",
                                {"query": QJ})
        results.append((status, body["kind"]))

    threads = [threading.Thread(target=client, args=(n,))
               for n in ("c1", "c2", "c3") for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 9
    assert all(s == 200 and k == "answer" for s, k in results)
    st = front.stats()["tenants"]
    for name in ("c1", "c2", "c3"):
        m = st[name]["metrics"]
        assert m["requests"] == 3 == (m["answered"] + m["degraded"]
                                      + m["failed"]
                                      + sum(m["rejected"].values()))


def test_front_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.serving.front, repro_torch.analysis;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
