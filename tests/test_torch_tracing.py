"""The port's span and counter recorder (``repro_torch.utils.tracing``) and
its sites in the service, the plan IR, the engine and the synopses.

Off, a site records nothing. On, the spans of a served workload nest as
the work does, across the service's client threads and the flushes they
run: each span's parent is the span open around it on its thread, and
each carries the id of the query it serves (a flush's, of the queries it
ran). The buffer keeps at most its capacity and counts what it drops;
``host_copy.bytes`` is the bytes of the tensors copied to the host. The
cost of one span site, off and on, is timed. A test on the card holds the
host-copy counter to the device-to-host copies the profiler sees.
"""
import threading
import timeit
import types

import numpy as np
import pytest
import torch

from repro_torch import verdict as vd
from repro_torch.aqp import queries as Q
from repro_torch.aqp.relation import Relation
from repro_torch.core import types as core_types
from repro_torch.core.types import Schema
from repro_torch.utils import tracing

ID, PARENT, NAME, START, END, THREAD, REQUEST, ATTRS = range(8)


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _session(device="cpu", rows=6000, seed=5, learning=True):
    rng = np.random.default_rng(seed)
    sch = Schema(num_lo=(0.0, 0.0), num_hi=(100.0, 10.0), cat_sizes=(4, 3),
                 n_measures=1)
    rel = Relation.from_columns(
        sch, np.stack([rng.uniform(0, 100, rows), rng.uniform(0, 10, rows)],
                      1),
        np.stack([rng.integers(0, 4, rows), rng.integers(0, 3, rows)], 1),
        rng.normal(50.0, 5.0, (rows, 1)), device=device)
    cfg = vd.EngineConfig(capacity=64, n_batches=4, learning=learning,
                          seed=seed)
    return vd.connect(rel, cfg)


def _queries(k, n):
    """``n`` distinct queries, one in two with a group-by (discovery)."""
    out = []
    for i in range(n):
        lo = 5.0 * ((7 * k + i) % 12)
        out.append(Q.AggQuery(
            aggs=(Q.AggSpec("AVG", 0),),
            predicates=(Q.NumRange(0, lo, lo + 30.0 + k),),
            groupby=(0,) if i % 2 else ()))
    return out


def _serve(session, clients=3, each=3):
    """Closed-loop clients through ``Session.serve``: each submits its
    next query when ``result()`` gave the last. Returns the queries."""
    svc = session.serve(max_batch=4, budget=vd.ErrorBudget(
        target_rel_error=0.05))
    asked = [_queries(k, each) for k in range(clients)]
    gate = threading.Barrier(clients)

    def client(qs):
        gate.wait()
        for q in qs:
            svc.submit(q).result(timeout=120)

    threads = [threading.Thread(target=client, args=(qs,))
               for qs in asked]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    session.drain()
    return [q for qs in asked for q in qs]


def test_off_a_site_records_nothing():
    a, b = tracing.span("x"), tracing.span("y", tuples=3)
    assert a is b  # the shared no-op context
    with a as sp:
        assert sp is None
    tracing.count("c")
    tracing.record("r", 1.0, 2.0)
    tracing.host_copy(types.SimpleNamespace(
        device=torch.device("cuda"), numel=lambda: 4, element_size=lambda: 8))
    assert tracing.stamp() is None
    _serve(_session(), clients=2, each=2)
    assert tracing.spans() == [] and tracing.counters() == {}


def test_on_spans_nest_across_client_and_flush_threads():
    session = _session()
    tracing.enable()
    asked = _serve(session)
    tracing.disable()
    spans = tracing.spans()
    by_id = {s[ID]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:  # a child lies inside its parent, on its thread
        if s[PARENT]:
            p = by_id[s[PARENT]]
            assert p[THREAD] == s[THREAD]
            assert p[START] <= s[START] <= s[END] <= p[END]
    kids = {}
    for s in spans:
        kids.setdefault(s[PARENT], []).append(s)
    ids = {id(q) for q in asked}
    flushes = [s for s in spans if s[NAME] == "service.flush"]
    assert flushes and sum(f[ATTRS]["queries"] for f in flushes) == len(ids)
    replayed = set()
    for f in flushes:
        assert len(f[REQUEST]) == f[ATTRS]["queries"]
        under = kids[f[ID]]
        assert [c[NAME] for c in under].count("plan") == 1
        replays = [c for c in under if c[NAME] == "replay.query"]
        assert {c[REQUEST] for c in replays} == set(f[REQUEST])
        for c in under:  # the flush's spans carry its queries' ids
            if c[NAME] == "plan":
                assert c[REQUEST] == f[REQUEST]
        for r in replays:  # and a query's spans its id
            stages = {c[NAME] for c in kids.get(r[ID], [])}
            assert {"replay.estimate", "replay.assemble",
                    "replay.improve", "replay.record"} <= stages
            assert all(c[REQUEST] == r[REQUEST] for c in kids[r[ID]])
            replayed.add(r[REQUEST])
    assert replayed == ids
    discover = [s for s in spans if s[NAME] == "plan.discover"]
    assert discover and all(by_id[s[PARENT]][NAME] == "plan"
                            for s in discover)
    assert any(by_id[s[PARENT]][NAME] == "replay.query"
               for s in spans if s[NAME] == "scan.block")
    queued = [s for s in spans if s[NAME] == "service.queued"]
    assert sorted(s[REQUEST] for s in queued) == sorted(ids)
    starts = {f[START] for f in flushes}
    for s in queued:  # each ends where the flush that took it began
        f = [f for f in flushes if s[REQUEST] in f[REQUEST]]
        assert len(f) == 1 and s[END] <= f[0][START] + 1e-3
    waits = [s for s in spans if s[NAME] == "service.lock_wait"]
    assert {s[ATTRS]["caller"] for s in waits} <= {"result", "submit"}
    events = [s for s in spans if s[NAME] == "service.event_wait"]
    assert {s[REQUEST] for s in events} <= ids and len(events) == len(ids)
    # each lock taken either ran a flush or found the queue empty
    assert (tracing.counters().get("service.empty_flush", 0)
            == len(waits) - len(flushes))
    assert len(starts) == len(flushes)
    threads = {s[THREAD] for s in flushes}
    assert threads and all(isinstance(t, int) for t in threads)


def test_learning_spans_drain_wait_and_ingest():
    session = _session()
    tracing.enable()
    _serve(session, clients=2, each=3)
    tracing.disable()
    names = [s[NAME] for s in tracing.spans()]
    assert "store.drain_wait" in names
    applies = names.count("ingest.apply")
    assert applies and names.count("ingest.queued") <= applies


def test_the_buffer_keeps_its_capacity_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span("s", tuples=i):
            pass
    got = tracing.spans()
    assert [s[ATTRS]["tuples"] for s in got] == [0, 1, 2]
    assert tracing.counters() == {tracing.DROPPED: 2}
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_host_copy_bytes_are_the_bytes_copied(monkeypatch):
    tracing.enable()
    shapes = [((3, 5), 8), ((7,), 1), ((2, 2, 2), 4)]
    for shape, size in shapes:
        tracing.host_copy(types.SimpleNamespace(
            device=torch.device("cuda"), numel=lambda s=shape: np.prod(s),
            element_size=lambda z=size: z))
    tracing.host_copy(torch.ones(100))  # already on the host: not counted
    assert tracing.counters() == {
        "host_copy.count": 3,
        "host_copy.bytes": sum(np.prod(s) * z for s, z in shapes)}
    seen = []
    monkeypatch.setattr(tracing, "host_copy", seen.append)
    x = torch.arange(6.0)
    core_types.to_numpy(x)
    core_types.to_numpy(np.arange(3))
    assert seen == [x]  # every tensor's copy goes through the counter


def test_span_site_cost_off_and_on():
    """One span site with two attributes, less an empty statement: off,
    then on with no profiler recording. Printed, and held to bounds a
    loaded test machine keeps: 2 us off (a ``with`` statement alone takes
    0.4-0.5 us on the hosts measured) and 25 us on (five times its
    budget)."""
    site = ("with tracing.span('scan.block', snippets=128, tuples=600000):"
            " pass")
    env = {"tracing": tracing}

    def cost(n):
        t = min(timeit.repeat(site, globals=env, number=n, repeat=7))
        base = min(timeit.repeat("pass", number=n, repeat=7))
        return (t - base) / n * 1e6

    off = cost(200_000)
    tracing.enable()
    on = cost(20_000)
    tracing.disable()
    print(f"span site: off {off:.3f} us, on {on:.3f} us")
    assert 0 < off < 2.0 and 0 < on < 25.0 and off < on


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_every_copy_to_the_host_on_the_card_is_counted(card):
    """A served workload on the card, learning off (the query path alone):
    ``host_copy.count`` equals the device-to-host copies the profiler
    sees, and ``host_copy.bytes`` the bytes of tensors handed to
    ``to_numpy``."""
    from torch.profiler import ProfilerActivity, profile

    xs = [torch.ones(3, 5, dtype=torch.float64, device="cuda"),
          torch.ones(9, dtype=torch.int32, device="cuda")]
    tracing.enable()
    for x in xs:
        core_types.to_numpy(x)
    assert tracing.counters()["host_copy.bytes"] == 15 * 8 + 9 * 4
    session = _session(device="cuda", rows=60000, learning=False)
    session.execute_many(_queries(0, 4))  # warm: builds and loads
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=torch._C._profiler._ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _serve(session, clients=2, each=3)
        torch.cuda.synchronize()
    copies = sum(e.count for e in prof.key_averages()
                 if "DtoH" in e.key or "Device -> Pageable" in e.key)
    assert tracing.counters()["host_copy.count"] == copies > 0
