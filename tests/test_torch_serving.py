"""The port's microbatching service (``repro_torch.serving.aqp``:
``Ticket``, ``AqpService``, ``Session.serve``) and the pieces it calls
(``BatchExecutor(mesh=, mesh_axis=, placement=)``,
``VerdictEngine.execute_many(mesh=)``, ``VerdictEngine._execute_raw_only``,
``ShardedSynopsisStore(devices=)``) against the JAX reference (CPU).

Mirrored here, each as a scenario run on both packages over the same
relation and workload (made from a seed with numpy) with the reference
test's own assertions: every test of ``test_serving_aqp.py`` whose result
can be compared; the service, scan-fault, deadline, ingest-fault and
sharded-store tests of ``test_faults.py``;
``test_intel.py::test_service_prescreen_skips_microbatch``; the placement
and raw-only tests of ``test_batch_executor.py``, ``test_sharded_scan.py``
and ``test_fused_scan.py``; and the ``devices=`` tests of
``test_synopsis_store.py``. Flushes run on one thread. The port's record
must equal the reference's: ``supported``, ``batches_used``,
``tuples_scanned``, ``degraded``, ``served_from`` and the cells' groups
equal, estimates and AVG cells' beta² within rtol 1e-9 (float64; 1e-3 for
the f32 improve kernel, the reference's own budget), COUNT and SUM cells'
beta² within 1e-8 (``FREQ_BETA2_RTOL``), failures of the same type after
the same number of attempts, counters equal.

The reference runs with ``async_ingest=False`` wherever a
workload-intelligence plane is attached: its router reads ``Synopsis.n``,
which races its ingest thread (ROADMAP Queue 3). No test here reads a
reference synopsis' ``n`` while its ingest thread runs.

The concurrency tests (exactly once under six submitting threads, the
retry before bisection) run on the port alone. A mesh is the CPU listed
four times on the port and four forced host devices on the reference.
"""
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh as JaxMesh  # noqa: E402

import repro.verdict as jvd  # noqa: E402
from repro.aqp import queries as jx_q  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.aqp.batch import BatchExecutor as JxBatchExecutor  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.core import store as jx_store  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.ft import faults as jx_faults  # noqa: E402
from repro.serving.aqp import AqpService as JxService  # noqa: E402
from repro.verdict.answer import FailedAnswer as JxFailed  # noqa: E402
from repro.verdict.answer import QueryAnswer as JxAnswer  # noqa: E402
import repro_torch.verdict as pvd  # noqa: E402
from repro_torch.aqp import queries as pt_q  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.aqp.batch import BatchExecutor as PtBatchExecutor  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import store as pt_store  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.ft import faults as pt_faults  # noqa: E402
from repro_torch.serving.aqp import AqpService as PtService  # noqa: E402
from repro_torch.verdict.answer import FailedAnswer as PtFailed  # noqa: E402
from repro_torch.verdict.answer import QueryAnswer as PtAnswer  # noqa: E402

N_SHARDS = 4
# beta² of the cells the FREQ synopsis feeds (COUNT, SUM): its improved
# variance cancels in gamma² = kappa² - k Σ⁻¹ kᵀ (seven digits at the sizes
# here; ROADMAP Queue 3), which grows the packages' last-bit differences.
FREQ_BETA2_RTOL = 1e-8

JAX = types.SimpleNamespace(
    name="jax", vd=jvd, Q=jx_q, W=jx_w, E=jx_engine, store=jx_store,
    T=jx_types, faults=jx_faults, Service=JxService,
    BatchExecutor=JxBatchExecutor, Failed=JxFailed, Answer=JxAnswer,
    rel={}, eng={}, sync=dict(async_ingest=False))
PORT = types.SimpleNamespace(
    name="torch", vd=pvd, Q=pt_q, W=pt_w, E=pt_engine, store=pt_store,
    T=pt_types, faults=pt_faults, Service=PtService,
    BatchExecutor=PtBatchExecutor, Failed=PtFailed, Answer=PtAnswer,
    rel={"device": "cpu"}, eng={"device": "cpu"}, sync={})
LIBS = (JAX, PORT)

# The reference tests' relations and engine configurations.
SERVE_REL = dict(seed=0, n_rows=5_000, n_num=2, cat_sizes=(4,), n_measures=1,
                 lengthscale=0.4, noise=0.2)
SERVE_CFG = dict(sample_rate=0.15, n_batches=4, capacity=128, seed=0)
FAULT_REL = dict(SERVE_REL, n_rows=4_000)
FAULT_CFG = dict(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
BATCH_REL = dict(SERVE_REL, n_rows=10_000)
BATCH_CFG = dict(sample_rate=0.15, n_batches=6, capacity=256, seed=0)
PLACE_REL = dict(SERVE_REL, seed=1, n_rows=3_700)
PLACE_CFG = dict(sample_rate=0.15, n_batches=3, capacity=128, seed=0)
STORE_REL = dict(SERVE_REL, n_rows=8_000, n_measures=2)
STORE_CFG = dict(sample_rate=0.15, n_batches=4, capacity=128, seed=0)


@pytest.fixture(scope="module")
def rels():
    """``rels[kind][package]``: each reference test's relation, made by
    both packages from the same seed."""
    out = {}
    for kind, kw in (("serve", SERVE_REL), ("fault", FAULT_REL),
                     ("batch", BATCH_REL), ("place", PLACE_REL),
                     ("store", STORE_REL)):
        out[kind] = {L.name: L.W.make_relation(**kw, **L.rel) for L in LIBS}
    return out


def _cfg(L, base, intel=False, **kw):
    cfg = dict(base)
    if intel:
        cfg.update(L.sync)
    cfg.update(kw)
    return L.E.EngineConfig(**cfg)


def _engine(L, rel, base=SERVE_CFG, **kw):
    return L.E.VerdictEngine(rel, _cfg(L, base, **kw), **L.eng)


def _workload(L, rel, n=12):
    return L.W.make_workload(1, rel.schema, n,
                             agg_kinds=("AVG", "COUNT", "SUM"),
                             cat_pred_prob=0.3)


def _mesh(L, forced_devices):
    if L is PORT:
        return pvd.Mesh(("cpu",) * N_SHARDS)
    return JaxMesh(np.array(forced_devices(N_SHARDS)), ("data",))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------- records


def _cells(ans):
    """(group, agg, kind, estimate, beta2) of each cell of an engine
    ``QueryResult`` (dict cells) or a facade ``QueryAnswer``."""
    out = []
    for c in ans.cells:
        if isinstance(c, dict):
            out.append((tuple(c["group"]), c["agg"], c["kind"],
                        c["estimate"], c["beta2"]))
        else:
            out.append((tuple(c.group), c.agg, c.kind, c.estimate, c.beta2))
    return out


ANSWER_FIELDS = ("supported", "batches_used", "tuples_scanned", "degraded",
                 "served_from", "truncated_groups")


def _same_records(got, want, rtol=1e-9):
    """The port's record against the reference's (module docstring)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if getattr(b, "failed", False) and not hasattr(b, "batches_used"):
            assert (a.error_type, a.attempts) == (b.error_type, b.attempts), i
            continue
        if not hasattr(b, "cells"):
            assert a == b, (i, a, b)
            continue
        assert ([getattr(a, f, None) for f in ANSWER_FIELDS]
                == [getattr(b, f, None) for f in ANSWER_FIELDS]), i
        ca, cb = _cells(a), _cells(b)
        assert [c[:3] for c in ca] == [c[:3] for c in cb], i
        np.testing.assert_allclose([c[3] for c in ca], [c[3] for c in cb],
                                   rtol=rtol, atol=0, err_msg=f"record {i}")
        for x, y in zip(ca, cb):
            tol = rtol if x[2] == "AVG" else max(rtol, FREQ_BETA2_RTOL)
            np.testing.assert_allclose(x[4], y[4], rtol=tol, atol=0,
                                       err_msg=f"record {i} beta2 {x[:3]}")


def _parity(scenario, *args, rtol=1e-9):
    """Run ``scenario(L, *args_for_L)`` on both packages; an argument that
    is a dict keyed by package name is given as that package's entry."""
    rec = {}
    for L in LIBS:
        la = [a[L.name] if isinstance(a, dict) and L.name in a else a
              for a in args]
        rec[L.name] = scenario(L, *la)
    _same_records(rec["torch"], rec["jax"], rtol=rtol)
    return rec


def _bitwise(r_a, r_b):
    """Two runs of one package: bitwise equal answers."""
    assert len(r_a) == len(r_b)
    for a, b in zip(r_a, r_b):
        assert a.supported == b.supported
        assert a.batches_used == b.batches_used
        assert _cells(a) == _cells(b)


def _results_equal(r_seq, r_bat):
    """``test_batch_executor.py``'s bitwise check of two runs of one
    package, the per-snippet improved answers included."""
    _bitwise(r_seq, r_bat)
    for a, b in zip(r_seq, r_bat):
        assert a.tuples_scanned == b.tuples_scanned
        if a.snippet_answer is not None:
            for f in ("theta", "beta2", "raw_theta", "raw_beta2",
                      "accepted"):
                np.testing.assert_array_equal(
                    _np(getattr(a.snippet_answer, f)),
                    _np(getattr(b.snippet_answer, f)), err_msg=f)


# ------------------------------------------- test_serving_aqp.py, mirrored


def _auto_flush(L, rel):
    wl = _workload(L, rel)
    svc = L.Service(_engine(L, rel), max_batch=4)
    tickets = [svc.submit(q) for q in wl[:3]]
    assert svc.flushes == 0 and svc.pending == 3
    assert not any(t._done for t in tickets)
    t4 = svc.submit(wl[3])  # hits the threshold exactly
    assert svc.flushes == 1 and svc.pending == 0
    assert all(t._done for t in tickets) and t4._done
    assert t4.result() is not None
    assert svc.flushes == 1  # resolved tickets answer without a flush
    svc.drain()
    return [t.result() for t in tickets] + [t4.result(), svc.flushes]


def test_auto_flush_threshold(rels):
    _parity(_auto_flush, rels["serve"])


def _result_flushes_once(L, rel):
    wl = _workload(L, rel)
    svc = L.Service(_engine(L, rel), max_batch=8)
    t1, t2 = svc.submit(wl[0]), svc.submit(wl[1])
    assert svc.flushes == 0
    r1 = t1.result()  # forces the flush for the whole pending batch
    assert svc.flushes == 1 and svc.pending == 0
    assert r1 is not None and t2._done
    assert t2.result() is not None
    assert svc.flushes == 1  # no extra flush for the sibling
    svc.drain()
    return [r1, t2.result()]


def test_ticket_result_triggers_flush_once(rels):
    _parity(_result_flushes_once, rels["serve"])


def _stats_propagation(L, rel):
    wl = _workload(L, rel)
    svc = L.Service(_engine(L, rel), max_batch=5)
    assert svc.last_stats is None
    first = svc.execute(wl[:5])
    assert svc.flushes == 1
    st = svc.last_stats
    assert st is not None and st.n_queries == 5
    assert st.eval_calls > 0 and st.batches_scanned > 0
    assert st.n_snippets_fused <= st.n_snippets_total
    counts = [st.n_queries, st.eval_calls, st.batches_scanned,
              st.tuples_scanned, st.n_snippets_total, st.n_snippets_fused]
    second = svc.execute(wl[5:8])
    assert svc.flushes == 2 and svc.last_stats.n_queries == 3
    svc.drain()
    return [*first, *second, counts]


def test_stats_propagation(rels):
    _parity(_stats_propagation, rels["serve"])


def _microbatched_parity(L, rel):
    wl = _workload(L, rel)
    svc = L.Service(_engine(L, rel), max_batch=5)
    tickets = [svc.submit(q) for q in wl[:10]]
    r_svc = [t.result() for t in tickets]
    assert svc.flushes == 2  # 5 + 5
    ref = _engine(L, rel)
    r_ref = ref.execute_many(wl[:5]) + ref.execute_many(wl[5:10])
    one = _engine(L, rel)
    r_one = one.execute_many(wl[:10])
    _bitwise(r_svc, r_ref)
    _bitwise(r_svc, r_one)
    for e in (svc.engine, ref, one):
        e.drain()
    return r_svc


def test_microbatched_parity_vs_direct_execute_many(rels):
    """Flushing a workload in microbatches is bitwise direct
    ``execute_many`` with the same flush boundaries, and ONE fused call."""
    _parity(_microbatched_parity, rels["serve"])


def _session_facade(L, rel):
    wl = _workload(L, rel)
    session = L.vd.connect(rel, _cfg(L, SERVE_CFG))
    svc = session.serve(max_batch=4,
                        budget=L.vd.ErrorBudget(target_rel_error=0.05))
    assert svc.engine is session.engine
    assert svc.target_rel_error == 0.05
    assert svc.executor.mesh is session._executor.mesh
    results = svc.execute(wl[:4])
    assert len(results) == 4
    assert all(r.batches_used >= 1 for r in results)
    # Built directly from a Session, the executor binds the engine.
    svc2 = L.Service(session, max_batch=8)
    assert svc2.engine is session.engine
    more = svc2.execute(wl[:2])
    assert more[0].supported
    session.drain()
    return [*results, *more]


def test_service_accepts_session_facade(rels):
    _parity(_session_facade, rels["serve"])


def _full_error_budget(L, rel):
    wl = _workload(L, rel)
    session = L.vd.connect(rel, _cfg(L, SERVE_CFG))
    svc = session.serve(budget=L.vd.ErrorBudget(max_batches=2, delta=0.9))
    results = svc.execute(wl[:4])
    assert all(r.batches_used == 2 for r in results)
    assert svc.max_batches == 2 and svc.stop_delta == 0.9
    session.drain()
    return results


def test_service_honors_full_error_budget(rels):
    _parity(_full_error_budget, rels["serve"])


def _typed_answers(L, rel):
    session = L.vd.connect(rel, _cfg(L, SERVE_CFG))
    svc = session.serve(max_batch=4)
    q = session.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0))
    ans = svc.submit(q).result()  # a builder, not an AggQuery
    assert isinstance(ans, L.Answer)
    assert ans.cells and isinstance(ans.cells[0], L.vd.Cell)
    twin = L.vd.connect(rel, _cfg(L, SERVE_CFG))
    direct = twin.execute(twin.query().avg("v0")
                          .where(L.vd.between("x0", 2.0, 8.0)))
    assert [c.to_dict() for c in ans.cells] == \
        [c.to_dict() for c in direct.cells]
    # The engine-level service lowers builders too.
    raw_svc = L.Service(_engine(L, rel), max_batch=4)
    count = raw_svc.submit(session.query().count()).result()
    assert count.supported
    for e in (session, twin, raw_svc):
        e.drain()
    return [ans, direct, count]


def test_serve_returns_typed_answers_and_lowers_builders(rels):
    _parity(_typed_answers, rels["serve"])


def _forced_raw_only(L, rel):
    eng = _engine(L, rel)
    q = _workload(L, rel)[0]  # a supported query
    r = eng._execute_raw_only(q, "forced by caller", max_batches=2)
    assert not r.supported and r.unsupported_reason == "forced by caller"
    assert r.batches_used == 2 and r.cells
    assert len(eng.store) == 0  # nothing learned
    return [r]


def test_forced_raw_only_contract(rels):
    """``_execute_raw_only`` forces the raw-only lifecycle even for a
    supported query: raw answers over the probe, nothing learned."""
    _parity(_forced_raw_only, rels["serve"])


def test_concurrent_submit_every_ticket_resolves_exactly_once(rels):
    """Six threads submit through the auto-flush threshold at once: every
    ticket resolves to a real answer EXACTLY once, nothing is lost or run
    twice, and a ``result()`` racing another thread's flush waits for it.
    Each flush is bitwise a direct ``execute_many`` of the same slice."""
    rel = rels["serve"]["torch"]
    wl = _workload(PORT, rel)
    svc = PtService(_engine(PORT, rel), max_batch=3)
    slices = []  # (queries, results) of each slice execution, in order
    inner = svc._execute_slice

    def spy(queries):
        out = inner(queries)
        slices.append((list(queries), out))
        return out

    svc._execute_slice = spy
    n_threads, per_thread = 6, 4
    tickets = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def submitter(slot):
        start.wait()
        for i in range(per_thread):
            q = wl[(slot * per_thread + i) % len(wl)]
            tickets[slot].append(svc.submit(q))

    threads = [threading.Thread(target=submitter, args=(s,))
               for s in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    svc.flush()  # the sub-threshold remainder
    all_tickets = [t for slot in tickets for t in slot]
    assert len(all_tickets) == n_threads * per_thread
    for t in all_tickets:
        ans = t.result(timeout=60)
        assert ans is not None and ans.supported is not None
        assert not getattr(ans, "failed", False)
        assert t.resolutions == 1  # exactly once, despite racing flushes
    assert svc.pending == 0
    # Each answer came from exactly one slice execution, and no query was
    # lost or run twice.
    executed = [r for _, out in slices for r in out]
    assert sorted(map(id, executed)) == sorted(
        id(t.result()) for t in all_tickets)
    # The slices, replayed in order through a twin engine, answer bitwise.
    twin = _engine(PORT, rel)
    for queries, out in slices:
        _bitwise(out, twin.execute_many(queries))
    svc.drain(), twin.drain()


def test_transient_fault_retries_whole_slice_before_bisecting(rels):
    """A transient fault (fires once) costs exactly two slice executions
    (fail, clean retry), never the bisection, and every answer is bitwise
    a twin's that never faulted."""
    rel = rels["serve"]["torch"]
    wl = _workload(PORT, rel)
    svc = PtService(_engine(PORT, rel), max_batch=64, max_retries=2,
                    backoff_base_s=0.001)
    calls = []
    inner = svc._execute_slice

    def counting(queries):
        calls.append(len(queries))
        return inner(queries)

    svc._execute_slice = counting
    tickets = [svc.submit(q) for q in wl[:4]]
    with pt_faults.inject(pt_faults.FaultSpec("scan.eval", hits=(0,))):
        svc.flush()
    assert calls == [4, 4]
    for t in tickets:
        assert not getattr(t.result(), "failed", False)
        assert t.resolutions == 1
    twin = PtService(_engine(PORT, rel), max_batch=64)
    clean = twin.execute(wl[:4])
    for t, c in zip(tickets, clean):
        assert t.result().cells == c.cells
    svc.drain(), twin.drain()


def _deadline_never_primes(L, rel):
    session = L.vd.connect(rel, _cfg(L, SERVE_CFG, intel=True), cache=True)
    svc = session.serve(max_batch=4,
                        budget=L.vd.ErrorBudget(deadline_s=0.0))
    q = session.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0)).build()
    first = svc.submit(q).result()
    assert first.degraded and "deadline" in first.degraded_reasons
    # Nothing degraded was recorded: the repeat is NOT prescreened.
    second_ticket = svc.submit(q)
    assert svc.prescreened == 0 and svc.pending == 1
    second = second_ticket.result()
    assert second.degraded and second.served_from is None
    assert session.stats()["intel"]["insertions"] == 0
    session.drain()
    return [first, second, svc.prescreened]


def test_deadline_degraded_flush_never_primes_the_answer_cache(rels):
    _parity(_deadline_never_primes, rels["serve"])


# ------------------------------------------------ test_intel.py, mirrored


def _prescreen(L, rel):
    s = L.vd.connect(rel, _cfg(L, SERVE_CFG, intel=True, sample_rate=0.2,
                                capacity=128), cache=True)
    svc = s.serve(budget=L.vd.ErrorBudget(target_rel_error=0.5))
    q = (s.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0))
         .group_by("c0").build())
    first = svc.submit(q).result()  # flushes
    t2 = svc.submit(q)
    assert t2._done and svc.pending == 0  # never occupied a slot
    assert svc.prescreened == 1
    got = t2.result()
    assert got.served_from == "cache:exact"
    assert _cells(got) == _cells(first)
    st = svc.stats()
    assert st["prescreened"] == 1 and st["intel"]["enabled"]
    s.drain()
    return [first, got, st["flushes"], st["intel"]["hits_exact"]]


def test_service_prescreen_skips_microbatch(rels, monkeypatch):
    """A cache hit resolves at submit and never enters a microbatch; on the
    port it reaches no scan, improve or record."""
    _parity(_prescreen, rels["serve"])
    rel = rels["serve"]["torch"]
    s = pvd.connect(rel, _cfg(PORT, SERVE_CFG), cache=True)
    svc = s.serve(budget=pvd.ErrorBudget(target_rel_error=0.5))
    q = s.query().avg("v0").where(pvd.between("x0", 2.0, 8.0)).build()
    svc.submit(q).result()
    s.drain()

    def forbidden(*a, **kw):
        raise AssertionError("a prescreened hit must not reach this")

    for obj, name in ((s.engine.scan, "eval_block"),
                      (s.store, "improve_groups"), (s.store, "record"),
                      (svc, "_execute_slice")):
        monkeypatch.setattr(obj, name, forbidden)
    assert svc.submit(q).result().served_from == "cache:exact"


# ------------------------------------------------ test_faults.py, mirrored


def _fault_queries(L, s):
    b = L.vd.between
    return [
        (s.query().avg("v0").where(b("x0", 2.0, 8.0)).group_by("c0")
         .build()),
        s.query().count().where(b("x0", 1.0, 6.0)).build(),
        s.query().sum("v0").where(b("x1", 0.0, 7.0)).build(),
        s.query().avg("v0").where(b("x1", 3.0, 9.0)).build(),
    ]


def _avg_key(L):
    return L.store.state_key(L.store.agg_key(L.T.AVG, 0))


def _transient_scan_fault(L, rel):
    oracle = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    chaos = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    qs = _fault_queries(L, oracle)
    oracle_svc = oracle.serve(budget=L.vd.ErrorBudget(max_batches=3))
    want = [oracle_svc.submit(q) for q in qs]
    oracle_svc.flush()
    svc = chaos.serve(budget=L.vd.ErrorBudget(max_batches=3))
    tickets = [svc.submit(q) for q in qs]
    with L.faults.inject(L.faults.FaultSpec("scan.eval", hits=(0,))) as plan:
        svc.flush()
        assert plan.fires.get("scan.eval") == 1
    for t, w in zip(tickets, want):
        assert t._done and not t.result().failed
        assert _cells(t.result()) == _cells(w.result())
    oracle.drain(), chaos.drain()
    return [t.result() for t in tickets]


def test_transient_scan_fault_absorbed_bitwise(rels):
    _parity(_transient_scan_fault, rels["fault"])


def _persistent_scan_fault(L, rel):
    session = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    svc = L.Service(session.engine, max_batch=64, max_batches=3,
                    max_retries=1, backoff_base_s=0.001)
    tickets = [svc.submit(q) for q in _fault_queries(L, session)]
    with L.faults.inject(L.faults.FaultSpec("scan.eval", rate=1.0)):
        out = svc.flush()
    assert len(out) == len(tickets)
    for t in tickets:
        assert t._done
        ans = t.result()
        assert isinstance(ans, L.Failed) and ans.failed
        assert ans.error_type == "InjectedFault"
        # The slice of 4 (1 + 1 retry), its half of 2, then the single
        # (1 + 1 retry).
        assert ans.attempts == 5
    ok = svc.submit(_fault_queries(L, session)[1])
    svc.flush()
    assert not isinstance(ok.result(), L.Failed)
    session.drain()
    return [t.result() for t in tickets] + [ok.result()]


def test_persistent_scan_fault_typed_failure_no_hung_tickets(rels):
    _parity(_persistent_scan_fault, rels["fault"])


def _states_equal(got_sd, want_sd):
    assert sorted(got_sd) == sorted(want_sd)
    for name in want_sd:
        for k in want_sd[name]:
            if k in ("ingest_high_water", "shard"):
                continue
            np.testing.assert_array_equal(np.asarray(got_sd[name][k]),
                                          np.asarray(want_sd[name][k]),
                                          err_msg=f"{name}/{k}")


def _ingest_fault_heals(L, rel):
    oracle = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    chaos = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    qs = _fault_queries(L, oracle)
    avg_key = _avg_key(L)
    want = oracle.execute_many(qs)
    oracle.drain()  # its applies share the fault key
    with L.faults.inject(L.faults.FaultSpec("ingest.apply", key=avg_key,
                                            hits=(0,))):
        got = chaos.execute_many(qs)
        assert len(got) == len(qs)
        assert got[3].degraded and avg_key in got[3].degraded_reasons
        assert got[2].degraded  # SUM improves through the AVG synopsis
        assert not got[1].degraded  # COUNT rides the FREQ key
        assert _cells(got[1]) == _cells(want[1])
        health = chaos.stats()["health"]
        assert avg_key in health["quarantined"]
        assert health["faults"]["ingest.apply"]["fires"] == 1
        rep = chaos.explain(qs[0])
        assert avg_key in rep.quarantined
        assert "QUARANTINED" in str(rep)
        chaos.drain()  # a plain barrier: the poison does not raise here
    assert chaos.stats()["health"]["faults"] == {}
    assert avg_key in chaos.stats()["health"]["quarantined"]
    assert chaos.heal() == {avg_key: True}
    assert chaos.stats()["health"]["quarantined"] == {}
    _states_equal(chaos.engine.store.state_dict(),
                  oracle.engine.store.state_dict())
    got2 = chaos.execute_many(qs)
    want2 = oracle.execute_many(qs)
    for g, w in zip(got2, want2):
        assert not g.degraded
        assert _cells(g) == _cells(w)
    chaos.drain(), oracle.drain()
    return [*got, *got2]


def test_ingest_fault_quarantines_degrades_and_heals_bitwise(rels):
    _parity(_ingest_fault_heals, rels["fault"])


def _drain_fault(L, rel):
    session = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    got = session.execute_many(_fault_queries(L, session))
    assert len(session.store) >= 2
    avg_key = _avg_key(L)
    with L.faults.inject(L.faults.FaultSpec("store.drain", key=avg_key,
                                            hits=(0,))):
        session.drain()  # never raises
    assert list(session.stats()["health"]["quarantined"]) == [avg_key]
    assert session.heal() == {avg_key: True}
    assert session.stats()["health"]["quarantined"] == {}
    return got


def test_drain_fault_blast_radius_is_one_synopsis(rels):
    _parity(_drain_fault, rels["fault"])


def _deadline_best_so_far(L, rel):
    session = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    q = _fault_queries(L, session)[0]
    ans = session.execute(q, L.vd.ErrorBudget(deadline_s=0.0))
    assert ans.final and ans.batches_used == 1
    assert ans.degraded and "deadline" in ans.degraded_reasons
    assert len(ans.cells) > 0
    s2 = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    s3 = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    slow = s2.execute(q, L.vd.ErrorBudget(deadline_s=3600.0))
    free = s3.execute(q)
    assert not slow.degraded
    assert _cells(slow) == _cells(free)
    for s in (session, s2, s3):
        s.drain()
    return [ans, slow]


def test_deadline_returns_best_so_far_degraded(rels):
    _parity(_deadline_best_so_far, rels["fault"])


def _deadline_stream_and_serve(L, rel):
    session = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    q = _fault_queries(L, session)[0]
    seen = list(session.stream(q, L.vd.ErrorBudget(deadline_s=0.0)))
    assert seen[-1].final and seen[-1].degraded
    assert "deadline" in seen[-1].degraded_reasons
    other = L.vd.connect(rel, _cfg(L, FAULT_CFG))
    svc = other.serve(budget=L.vd.ErrorBudget(deadline_s=0.0))
    t = svc.submit(q)
    svc.flush()
    ans = t.result()
    assert not ans.failed and ans.degraded
    assert "deadline" in ans.degraded_reasons
    session.drain(), other.drain()
    return [seen[-1], ans]


def test_deadline_in_stream_and_serve(rels):
    _parity(_deadline_stream_and_serve, rels["fault"])


def _sharded_quarantine(L, rel, mesh):
    chaos = L.vd.connect(rel, _cfg(L, FAULT_CFG), mesh=mesh)
    twin = L.vd.connect(rel, _cfg(L, FAULT_CFG), mesh=mesh)
    qs = _fault_queries(L, chaos)
    avg_key = _avg_key(L)
    with L.faults.inject(L.faults.FaultSpec("ingest.apply", key=avg_key,
                                            hits=(0,))):
        got = chaos.execute_many(qs)
        assert len(got) == len(qs)
        assert got[3].degraded
        assert list(chaos.stats()["health"]["quarantined"]) == [avg_key]
        chaos.drain()  # the per-shard barrier never raises
    want = twin.execute_many(qs)
    assert _cells(got[1]) == _cells(want[1])
    assert chaos.heal() == {avg_key: True}
    _states_equal(chaos.engine.store.state_dict(),
                  twin.engine.store.state_dict())
    twin.drain()
    return [*got, *want]


def test_sharded_store_quarantine_blast_radius(rels, forced_devices):
    """The quarantine stays one synopsis (so at most one shard) over a
    four-shard mesh; drain never raises across the shard barrier threads,
    and heal restores bitwise parity with a sharded twin."""
    meshes = {L.name: _mesh(L, forced_devices) for L in LIBS}
    _parity(_sharded_quarantine, rels["fault"], meshes)


# ---------------------------------- BatchExecutor: placement and raw-only


def _routes_through_placement(L, rel, mesh):
    local_eng = _engine(L, rel, PLACE_CFG)
    shard_eng = _engine(L, rel, PLACE_CFG)
    # 3700 * 0.15 = 555 sample rows in 3 batches: 185 a block, which four
    # shards do not divide.
    assert all(len(b) % N_SHARDS for b in shard_eng.batches.batch_rows)
    bx_local = L.BatchExecutor(local_eng)
    assert bx_local.placement is local_eng.scan  # the engine's seam
    bx_shard = L.BatchExecutor(shard_eng, mesh=mesh)
    assert bx_shard.placement.mesh is mesh and bx_shard.mesh is mesh
    assert bx_shard.mesh_axis == "data"
    qs = _workload(L, rel, 6)
    r_local = bx_local.execute_many(qs)
    r_shard = bx_shard.execute_many(qs)
    _bitwise(r_local, r_shard)
    for a, b in zip(r_local, r_shard):
        assert a.tuples_scanned == b.tuples_scanned
    per_batch = [len(b) for b in shard_eng.batches.batch_rows]
    st = bx_shard.stats
    assert st.tuples_scanned == sum(per_batch[:st.batches_scanned])
    assert bx_shard.placement.pad_rows > 0
    # The engine's own placement took no block of the mesh run.
    assert shard_eng.scan.blocks_evaluated == 0
    # execute_many(mesh=) is the same route.
    via_engine = _engine(L, rel, PLACE_CFG).execute_many(qs, mesh=mesh)
    _bitwise(r_local, via_engine)
    local_eng.drain(), shard_eng.drain()
    return [*r_shard, bx_shard.placement.pad_rows, st.tuples_scanned]


def test_batch_executor_routes_through_placement(rels, forced_devices):
    """``BatchExecutor._eval`` is ``placement.eval_block``: a mesh builds a
    sharded placement, no mesh adopts the engine's, and a workload over a
    relation the mesh does not divide answers bitwise the local engine."""
    meshes = {L.name: _mesh(L, forced_devices) for L in LIBS}
    _parity(_routes_through_placement, rels["place"], meshes)


def test_batch_executor_takes_a_placement_and_checks_the_axis(rels):
    """The port alone: ``placement=`` is used as given, and a
    ``mesh_axis`` that is not the mesh's one axis raises."""
    from repro_torch.aqp.executor import ShardedScanPlacement

    rel = rels["place"]["torch"]
    eng = _engine(PORT, rel, PLACE_CFG)
    mesh = pvd.Mesh(("cpu",) * N_SHARDS)
    placement = ShardedScanPlacement(mesh)
    bx = PtBatchExecutor(eng, placement=placement)
    assert bx.placement is placement and bx.mesh is mesh
    qs = _workload(PORT, rel, 3)
    got = bx.execute_many(qs)
    assert placement.blocks_evaluated == bx.stats.eval_calls > 0
    _bitwise(got, _engine(PORT, rel, PLACE_CFG).execute_many(qs))
    with pytest.raises(ValueError, match="mesh_axis"):
        PtBatchExecutor(eng, mesh=mesh, mesh_axis="model")
    eng.drain()


def _kernel_mesh_parity(L, rel, mesh):
    cfg = dict(sample_rate=0.2, n_batches=3, capacity=128, seed=0)
    qs = L.W.make_workload(3, rel.schema, 5,
                           agg_kinds=("AVG", "COUNT", "SUM"),
                           cat_pred_prob=0.3)
    eng_kernel = _engine(L, rel, cfg, use_kernels=True)
    eng_mesh = _engine(L, rel, cfg, use_kernels=True)
    r_kernel = L.BatchExecutor(eng_kernel).execute_many(qs)
    r_mesh = L.BatchExecutor(eng_mesh, mesh=mesh).execute_many(qs)
    _bitwise(r_kernel, r_mesh)
    for a, b in zip(r_kernel, r_mesh):
        assert a.tuples_scanned == b.tuples_scanned
    eng_kernel.drain(), eng_mesh.drain()
    return r_mesh


def test_kernel_engine_local_and_mesh_are_bitwise(rels, forced_devices):
    """``use_kernels=True`` (the f32 improve kernel): the local scan and
    the masked sharded scan are the same fold, so answers are bitwise; the
    packages agree within the f32 kernel's 1e-3 budget."""
    rel2 = {L.name: L.W.make_relation(
        seed=2, n_rows=2_000, n_num=2, cat_sizes=(4,), n_measures=1,
        lengthscale=0.4, noise=0.2, **L.rel) for L in LIBS}
    meshes = {L.name: _mesh(L, forced_devices) for L in LIBS}
    _parity(_kernel_mesh_parity, rel2, meshes, rtol=1e-3)


def _unsupported_and_empty(L, rel):
    Q = L.Q
    qs = [
        Q.AggQuery(aggs=(Q.AggSpec("AVG", 0),),
                   predicates=(Q.TextLike("%x%"), Q.NumRange(0, 1.0, 5.0))),
        Q.AggQuery(aggs=(Q.AggSpec("MIN", 0),), predicates=()),
        Q.AggQuery(aggs=(Q.AggSpec("AVG", 0),),
                   predicates=(Q.NumRange(0, 2.0, 8.0),), groupby=(0,)),
        Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                   predicates=(Q.NumRange(0, 99.0, 100.0),), groupby=(0,)),
    ]
    seq = _engine(L, rel, BATCH_CFG)
    bat = _engine(L, rel, BATCH_CFG)
    r_seq = [seq.execute(q) for q in qs]
    r_bat = L.BatchExecutor(bat).execute_many(qs)
    assert not r_bat[0].supported and "textual" in r_bat[0].unsupported_reason
    assert not r_bat[1].supported
    assert r_bat[3].cells == [] and r_bat[3].supported
    _results_equal(r_seq, r_bat)
    assert len(bat.store) == len(seq.store)  # raw-only learns nothing
    seq.drain(), bat.drain()
    return r_bat


def test_unsupported_and_empty_group_queries_match_sequential(rels):
    _parity(_unsupported_and_empty, rels["batch"])


def _only_empty_plans(L, rel):
    Q = L.Q
    q = Q.AggQuery(aggs=(Q.AggSpec("AVG", 0),),
                   predicates=(Q.TextLike("%x%"),
                               Q.NumRange(0, 99.0, 100.0)),
                   groupby=(0,))
    seq = _engine(L, rel, BATCH_CFG)
    bat = _engine(L, rel, BATCH_CFG)
    r_seq = [seq.execute(q)]
    r_bat = L.BatchExecutor(bat).execute_many([q])
    assert r_bat[0].cells == [] and not r_bat[0].supported
    _results_equal(r_seq, r_bat)
    return r_bat


def test_workload_of_only_empty_plans(rels):
    _parity(_only_empty_plans, rels["batch"])


def _kernel_parity_raw_only(L, rel):
    Q = L.Q
    qs = L.W.make_workload(5, rel.schema, 6, agg_kinds=("AVG", "COUNT"))
    qs.append(Q.AggQuery(aggs=(Q.AggSpec("AVG", 0),),
                         predicates=(Q.TextLike("%a%"),
                                     Q.NumRange(0, 2.0, 8.0))))
    seq = _engine(L, rel, BATCH_CFG, n_batches=3, use_kernels=True)
    bat = _engine(L, rel, BATCH_CFG, n_batches=3, use_kernels=True)
    r_seq = [seq.execute(q) for q in qs]
    r_bat = L.BatchExecutor(bat).execute_many(qs)
    _results_equal(r_seq, r_bat)
    seq.drain(), bat.drain()
    return r_bat


def test_kernel_engine_parity_including_raw_only(rels):
    """``use_kernels=True``: supported queries and raw-only probes scan
    alike in both paths, so sequential and batched agree bitwise; the
    packages within the f32 kernel's 1e-3 budget."""
    _parity(_kernel_parity_raw_only, rels["batch"], rtol=1e-3)


def _service_microbatches(L, rel):
    qs = L.W.make_workload(1, rel.schema, 30,
                           agg_kinds=("AVG", "COUNT", "SUM"),
                           cat_pred_prob=0.3)
    wl = (qs + qs[:20])[:50]
    eng_svc = _engine(L, rel, BATCH_CFG)
    eng_ref = _engine(L, rel, BATCH_CFG)
    svc = L.Service(eng_svc, max_batch=8)
    tickets = [svc.submit(q) for q in wl[:10]]
    assert svc.flushes == 1  # 8 hit the threshold, 2 still queued
    results = [t.result() for t in tickets]  # forces the second flush
    assert svc.flushes == 2
    r_ref = L.BatchExecutor(eng_ref).execute_many(wl[:8])
    _results_equal(r_ref, results[:8])
    assert svc.last_stats is not None
    more = svc.execute(wl[10:14])
    assert len(more) == 4 and all(r.supported for r in more)
    eng_svc.drain(), eng_ref.drain()
    return [*results, *more]


def test_aqp_service_microbatches(rels):
    _parity(_service_microbatches, rels["batch"])


# ------------------------------------ ShardedSynopsisStore(devices=...)


def _devices(L, forced_devices):
    return (["cpu"] * N_SHARDS if L is PORT
            else list(forced_devices(N_SHARDS)))


def _sharded_engine(L, rel, devices):
    store = lambda schema, c: L.store.ShardedSynopsisStore(  # noqa: E731
        schema, c, devices=devices)
    return L.E.VerdictEngine(rel, _cfg(L, STORE_CFG), store=store, **L.eng)


def _sharded_store_bitwise_local(L, rel, devices):
    wl = L.W.make_workload(1, rel.schema, 24,
                           agg_kinds=("AVG", "COUNT", "SUM"),
                           cat_pred_prob=0.3)
    local = _engine(L, rel, STORE_CFG)
    shard = _sharded_engine(L, rel, devices)
    assert isinstance(local.store, L.store.LocalSynopsisStore)
    assert isinstance(shard.store, L.store.ShardedSynopsisStore)
    assert len(shard.store.devices) == N_SHARDS
    r_local = local.execute_many(wl)
    r_shard = shard.execute_many(wl)
    _results_equal(r_local, r_shard)
    assert local.store.keys() == shard.store.keys()
    local.drain(), shard.drain()
    for key in local.store:
        a = local.store.get(key).state_dict()
        b = shard.store.get(key).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=str((key, k)))
    # Keys land on their assigned devices; placement is the key's hash.
    spread = set()
    for key, syn in shard.store.items():
        i = shard.store.shard_index(key)
        assert i == (key[0] * 8191 + key[1]) % N_SHARDS
        spread.add(i)
        if L is PORT:
            assert syn.device == shard.store.devices[i]
    assert len(spread) >= 2
    return [*r_shard, sorted(spread)]


def test_sharded_store_devices_bitwise_local(rels, forced_devices):
    """``ShardedSynopsisStore(devices=...)`` answers (cells, per-snippet
    improved answers, learned state) bitwise like the local store, and each
    key's synopsis lives on the device its hash picks."""
    devices = {L.name: _devices(L, forced_devices) for L in LIBS}
    _parity(_sharded_store_bitwise_local, rels["store"], devices)


def test_a_checkpoint_replaces_onto_a_subset_of_devices(rels, tmp_path):
    """A four-shard checkpoint restores bitwise into a store over the first
    device alone (``devices=devices[:1]``) and into the local store, and
    both answer alike afterwards."""
    from repro_torch.ft.checkpoint import CheckpointManager

    rel = rels["store"]["torch"]
    wl = PORT.W.make_workload(1, rel.schema, 14,
                              agg_kinds=("AVG", "COUNT", "SUM"),
                              cat_pred_prob=0.3)
    devices = ["cpu"] * N_SHARDS
    eng = _sharded_engine(PORT, rel, devices)
    eng.execute_many(wl[:10])
    eng.refit(steps=15)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    eng.save_synopses(mgr, step=1)
    narrow = _sharded_engine(PORT, rel, devices[:1])
    assert narrow.load_synopses(mgr)["kind"] == "verdict-synopses"
    assert len(narrow.store.devices) == 1
    local = _engine(PORT, rel, STORE_CFG)
    local.load_synopses(mgr)
    want = eng.synopses_state_dict()
    for other in (narrow, local):
        _states_equal(other.synopses_state_dict(), want)
    r = eng.execute_many(wl[10:], max_batches=2)
    for other in (narrow, local):
        _results_equal(r, other.execute_many(wl[10:], max_batches=2))
    for e in (eng, narrow, local):
        e.drain()


def test_a_sharded_store_without_devices_needs_a_card(rels):
    """With neither a mesh nor ``devices``, the store spans every visible
    CUDA card; with none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    rel = rels["store"]["torch"]
    with pytest.raises(ValueError, match="at least one device"):
        pt_store.ShardedSynopsisStore(rel.schema, _cfg(PORT, STORE_CFG))


def test_serving_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.serving, repro_torch.verdict;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    import os

    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
