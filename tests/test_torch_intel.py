"""The port's workload-intelligence plane (``repro_torch.intel``: answer
cache, subsumption serving, staleness licensing, the learned serve-path
router and its ladder, telemetry, checkpoints) against the JAX reference's
``repro.intel`` (CPU).

Every test of ``test_intel.py`` but the microbatching service's (the
serving front is not ported yet) runs here as a scenario: the same calls on
a session of each package, over the same relation and queries (made from a
seed with numpy), each with the reference test's own assertions. Then the
two packages' records must agree:
  - ``served_from``, ``batches_used``, ``supported``, ``degraded`` and
    ``truncated_groups`` of every answer, equal;
  - every answer's cells within the engine's rtol 1e-9 (float64);
  - ``stats()["intel"]`` (every counter, the routes, the router's learned
    E[batches] and ladder floors), ``QuerySignature.digest()`` strings and
    whatever else a scenario records, equal.
The reference runs with ``async_ingest=False``: its router reads
``Synopsis.n``, which under asynchronous ingest depends on how far the
ingest thread has got (``test_intel.py::test_router_learns_scan_route_bitwise``
passes or fails with the machine's load). The port's router reads the fill
counted at enqueue time, so the port runs with its default asynchronous
ingest and must equal the reference's synchronous run; the router's
scenario runs the port under both modes and requires bitwise equal answers
and equal routes. Intel checkpoints cross-load both ways, re-licensing the
same entries as fresh or stale.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.verdict as jvd  # noqa: E402
from repro.aqp import queries as jx_q  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.aqp.plan import plan_workload as jx_plan_workload  # noqa: E402
from repro.core import append as jx_append  # noqa: E402
from repro.core.store import agg_key as jx_agg_key  # noqa: E402
from repro.core.store import state_key as jx_state_key  # noqa: E402
from repro.ft import faults as jx_faults  # noqa: E402
from repro.ft.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.intel import IntelConfig as JxIntelConfig  # noqa: E402
from repro.intel import QuerySignature as JxSignature  # noqa: E402
from repro.intel import RouterConfig as JxRouterConfig  # noqa: E402
from repro.kernels import RANGE_EPS as JX_RANGE_EPS  # noqa: E402
from repro.verdict.session import Session as JxSession  # noqa: E402
import repro_torch.verdict as pvd  # noqa: E402
from repro_torch.aqp import queries as pt_q  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.aqp.plan import plan_workload as pt_plan_workload  # noqa: E402
from repro_torch.core import append as pt_append  # noqa: E402
from repro_torch.core.store import agg_key as pt_agg_key  # noqa: E402
from repro_torch.core.store import state_key as pt_state_key  # noqa: E402
from repro_torch.core.types import AVG  # noqa: E402
from repro_torch.ft import faults as pt_faults  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager as PtManager  # noqa: E402
from repro_torch.intel import IntelConfig as PtIntelConfig  # noqa: E402
from repro_torch.intel import QuerySignature as PtSignature  # noqa: E402
from repro_torch.intel import RouterConfig as PtRouterConfig  # noqa: E402
from repro_torch.kernels import RANGE_EPS as PT_RANGE_EPS  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.verdict.session import Session as PtSession  # noqa: E402

REL_KW = dict(seed=0, n_rows=3_000, n_num=2, cat_sizes=(4,), n_measures=1,
              lengthscale=0.4, noise=0.2)

JAX = types.SimpleNamespace(
    name="jax", vd=jvd, Q=jx_q, faults=jx_faults, Manager=JaxManager,
    IntelConfig=JxIntelConfig, RouterConfig=JxRouterConfig,
    QuerySignature=JxSignature, plan_workload=jx_plan_workload,
    RANGE_EPS=JX_RANGE_EPS, Session=JxSession, append=jx_append,
    AVG_KEY=jx_state_key(jx_agg_key(AVG, 0)),
    cfg=dict(async_ingest=False))
PORT = types.SimpleNamespace(
    name="torch", vd=pvd, Q=pt_q, faults=pt_faults, Manager=PtManager,
    IntelConfig=PtIntelConfig, RouterConfig=PtRouterConfig,
    QuerySignature=PtSignature, plan_workload=pt_plan_workload,
    RANGE_EPS=PT_RANGE_EPS, Session=PtSession, append=pt_append,
    AVG_KEY=pt_state_key(pt_agg_key(AVG, 0)), cfg={})
LIBS = (JAX, PORT)


@pytest.fixture(scope="module")
def rels():
    return {"jax": jx_w.make_relation(**REL_KW),
            "torch": pt_w.make_relation(**REL_KW, device="cpu")}


def _cfg(L, **kw):
    base = dict(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
    base.update(L.cfg)
    base.update(kw)
    return L.vd.EngineConfig(**base)


def _cells(ans):
    return [c.to_dict() for c in ans.cells]


def _budget(L):
    return L.vd.ErrorBudget(target_rel_error=0.5)


def _q_grouped(L, s):
    return (s.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0))
            .group_by("c0").build())


def _q_plain(L, s):
    return s.query().avg("v0").where(L.vd.between("x1", 1.0, 6.0)).build()


def _q_pin(L, s):
    return (s.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0))
            .where(L.vd.equals("c0", 1)).group_by("c0").build())


def _same_records(got, want):
    """The port's record against the reference's (module docstring)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if not hasattr(b, "cells"):
            assert a == b, (i, a, b)
            continue
        fields = ("served_from", "batches_used", "supported", "degraded",
                  "truncated_groups", "final")
        assert ([getattr(a, f) for f in fields]
                == [getattr(b, f) for f in fields]), i
        assert ([(c.group, c.agg, c.kind) for c in a.cells]
                == [(c.group, c.agg, c.kind) for c in b.cells]), i
        for f in ("estimate", "beta2"):
            np.testing.assert_allclose(
                [getattr(c, f) for c in a.cells],
                [getattr(c, f) for c in b.cells], rtol=1e-9, atol=0,
                err_msg=f"answer {i} {f}")


def _parity(scenario, rels, *args):
    """Run ``scenario(L, relation, *args)`` on both packages and hold the
    port's record to the reference's."""
    records = {L.name: scenario(L, rels[L.name], *args) for L in LIBS}
    _same_records(records["torch"], records["jax"])
    return records


# ------------------------------------------------------------- default off


def _cache_off_by_default(L, rel):
    s = L.vd.connect(rel, _cfg(L))
    assert s.intel is None and s.engine.intel is None
    ans = s.execute(_q_grouped(L, s), _budget(L))
    assert ans.served_from is None
    assert s.stats()["intel"] == {"enabled": False}
    rep = s.explain(_q_grouped(L, s))
    assert rep.cache is None and rep.route is None
    assert "served from cache" not in str(rep)
    s.drain()
    return [ans, s.stats()["intel"]]


def test_cache_off_by_default(rels):
    _parity(_cache_off_by_default, rels)


# -------------------------------------------------- exact hits, miss parity


def _exact_hit_and_miss_parity(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    twin = L.vd.connect(rel, _cfg(L))  # cache-disabled oracle
    q1, q2 = _q_grouped(L, s), _q_plain(L, s)
    first = s.execute_many([q1, q2], B)
    want = twin.execute_many([q1, q2], B)
    for g, w in zip(first, want):
        assert g.served_from is None
        assert _cells(g) == _cells(w)
    q3 = s.query().count().where(L.vd.between("x0", 1.0, 9.0)).build()
    again = s.execute_many([q1, q3, q2], B)
    assert again[0].served_from == "cache:exact"
    assert again[2].served_from == "cache:exact"
    assert again[1].served_from is None
    assert _cells(again[0]) == _cells(first[0])
    assert _cells(again[2]) == _cells(first[1])
    st = s.stats()["intel"]
    assert st["enabled"] and st["hits_exact"] == 2
    assert st["entries"] == 3 and st["insertions"] == 3
    assert st["routes"]["cache"] == 2
    s.drain(), twin.drain()
    return [*first, *want, *again, st]


def test_exact_hit_bitwise_and_miss_parity(rels):
    _parity(_exact_hit_and_miss_parity, rels)


def test_a_hit_launches_no_kernel_and_copies_nothing(rels, monkeypatch):
    """The port alone: a hit reaches no stage that launches a kernel (the
    group probe, the scan, improve, record) and touches no tensor (every
    cached cell is a Python float). On the card ``chip_smoke.py`` phase 7
    and ``test_torch_gpu.py`` hold the launch counters still across hits.
    (The admission test's confidence multiplier is a host scalar.)"""
    rel = rels["torch"]
    s = pvd.connect(rel, _cfg(PORT), cache=True)
    q = _q_grouped(PORT, s)
    first = s.execute(q, _budget(PORT))
    s.drain()
    for entry in s.intel.cache._entries.values():
        for cell in entry.cells:
            assert all(type(cell[k]) is float for k in ("estimate", "beta2"))
    before = launch_counts()

    def forbidden(*a, **kw):
        raise AssertionError("a cache hit must not reach this")

    for obj, name in ((s.engine, "_discover_groups_many"),
                      (s.engine.scan, "eval_block"),
                      (s.store, "improve_groups"), (s.store, "record"),
                      (torch.Tensor, "numpy"), (torch.Tensor, "cpu"),
                      (torch.Tensor, "item"), (torch.Tensor, "tolist")):
        monkeypatch.setattr(obj, name, forbidden)
    hits = [s.execute(q, _budget(PORT)), *s.stream(q, _budget(PORT))]
    monkeypatch.undo()
    for hit in hits:
        assert hit.served_from == "cache:exact"
        assert _cells(hit) == _cells(first)
    assert launch_counts() == before


def _full_accuracy_needs_full_budget(L, rel):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_plain(L, s)
    first = s.execute(q)
    again = s.execute(q)
    assert again.served_from == "cache:exact"
    assert _cells(again) == _cells(first)
    capped = s.execute(q, L.vd.ErrorBudget(max_batches=2))
    assert capped.served_from is None
    assert capped.batches_used == 2
    s.drain()
    return [first, again, capped, s.stats()["intel"]]


def test_full_accuracy_exact_hit_requires_full_budget(rels):
    _parity(_full_accuracy_needs_full_budget, rels)


def _uncacheable(L, rel):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    bad = L.Q.AggQuery(aggs=(L.Q.AggSpec("AVG", 0),),
                       predicates=(L.Q.TextLike("x%"),))
    a1 = s.execute(bad)
    a2 = s.execute(bad)
    assert not a1.supported and not a2.supported
    assert a2.served_from is None
    assert s.stats()["intel"]["uncacheable"] == 2
    assert L.QuerySignature.from_query(s.schema, bad) is None
    s.drain()
    return [a1, a2, s.stats()["intel"]]


def test_uncacheable_query_counted_and_served_raw(rels):
    _parity(_uncacheable, rels)


# ------------------------------------------------------ staleness licensing


def _ingest_invalidates(L, rel):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q_a, q_b = _q_grouped(L, s), _q_plain(L, s)
    out = [s.execute(q_a), s.execute(q_a)]
    assert out[1].served_from == "cache:exact"
    out.append(s.execute(q_b))
    out.append(s.execute(q_a))
    assert out[-1].served_from is None  # stale → refused → re-executed
    assert s.stats()["intel"]["stale_refused"] >= 1
    out.append(s.execute(q_a))
    assert out[-1].served_from == "cache:exact"
    s.drain()
    return out + [s.stats()["intel"]]


def test_ingest_invalidates_full_accuracy_then_refreshes(rels):
    _parity(_ingest_invalidates, rels)


def _stale_within_budget(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q_a, q_b = _q_grouped(L, s), _q_plain(L, s)
    first = s.execute(q_a, B)
    other = s.execute(q_b, B)
    served = s.execute(q_a, B)
    assert served.served_from == "cache:exact"
    assert _cells(served) == _cells(first)
    assert served.max_rel_error(0.95) <= B.target_rel_error
    assert s.stats()["intel"]["stale_served"] >= 1
    s.drain()
    return [first, other, served, s.stats()["intel"]]


def test_stale_entry_serves_within_error_budget(rels):
    _parity(_stale_within_budget, rels)


def _append_and_refit_make_stale(L, rel):
    """A full-accuracy entry is refused after ``refit`` and after an
    ``apply_append``: each moves the generation of every synopsis."""
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_grouped(L, s)
    out = [s.execute(q), s.execute(q)]
    assert out[1].served_from == "cache:exact"
    gens = {k: s.store.generation(k) for k in s.store.keys()}
    s.refit(steps=5)
    assert all(s.store.generation(k) == g + 1 for k, g in gens.items())
    out.append(s.execute(q))
    assert out[-1].served_from is None
    out.append(s.execute(q))
    assert out[-1].served_from == "cache:exact"
    old = np.asarray(rel.measures[:500])
    stats = L.append.estimate_append_stats(old, old + 0.8, rel.cardinality,
                                           600)
    gens = {k: s.store.generation(k) for k in s.store.keys()}
    for _, syn in s.store.items():
        syn.apply_append(stats)
    assert all(s.store.generation(k) == g + 1 for k, g in gens.items())
    out.append(s.execute(q))
    assert out[-1].served_from is None
    s.drain()
    return out + [s.stats()["intel"]]


def test_refit_and_append_make_cached_answers_stale(rels):
    _parity(_append_and_refit_make_stale, rels)


# ------------------------------------------------------------- subsumption


def _subsumption_pin_and_subset(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    full = s.execute(_q_grouped(L, s), B)
    got = s.execute(_q_pin(L, s), B)
    assert got.served_from == "cache:subsumed"
    assert _cells(got) == [c for c in _cells(full) if c["group"] == (1,)]
    sub = (s.query().avg("v0").where(L.vd.between("x0", 2.0, 8.0))
           .where(L.vd.one_of("c0", [3, 0])).group_by("c0").build())
    got2 = s.execute(sub, B)
    assert got2.served_from == "cache:subsumed"
    assert _cells(got2) == [c for c in _cells(full)
                            if c["group"][0] in (0, 3)]
    merged = (s.query().avg("v0")
              .where(L.vd.between("x0", 2.0, 8.0)).build())
    got3 = s.execute(merged, B)
    assert got3.served_from is None
    assert s.stats()["intel"]["hits_subsumed"] == 2
    s.drain()
    return [full, got, got2, got3, s.stats()["intel"]]


def test_subsumption_group_pin_and_subset(rels):
    _parity(_subsumption_pin_and_subset, rels)


def _range_eps_boundary(L, rel):
    B = _budget(L)
    Q, eps = L.Q, L.RANGE_EPS
    s = L.vd.connect(rel, _cfg(L), cache=True)
    aggs = (Q.AggSpec("AVG", 0),)
    base = Q.AggQuery(aggs=aggs, predicates=(Q.NumRange(0, 2.0, 8.0),),
                      groupby=(0,))
    first = s.execute(base, B)
    near = Q.AggQuery(aggs=aggs,
                      predicates=(Q.NumRange(0, 2.0 + eps / 2,
                                             8.0 - eps / 2),),
                      groupby=(0,))
    got = s.execute(near, B)
    assert got.served_from == "cache:subsumed"
    assert _cells(got) == _cells(first)
    far = Q.AggQuery(aggs=aggs,
                     predicates=(Q.NumRange(0, 2.0 + 1e-6, 8.0),),
                     groupby=(0,))
    got_far = s.execute(far, B)
    assert got_far.served_from is None
    s.drain()
    return [first, got, got_far, s.stats()["intel"]]


def test_subsumption_range_eps_boundary(rels):
    assert PT_RANGE_EPS == JX_RANGE_EPS
    _parity(_range_eps_boundary, rels)


def _truncated_never_subsumes(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L, n_max=2), cache=True)
    q = _q_grouped(L, s)
    first = s.execute(q, B)
    assert first.truncated_groups > 0
    again = s.execute(q, B)
    assert again.served_from == "cache:exact"
    assert again.truncated_groups == first.truncated_groups
    pin = s.execute(_q_pin(L, s), B)
    assert pin.served_from is None
    s.drain()
    return [first, again, pin, s.stats()["intel"]]


def test_truncated_entry_never_subsumes(rels):
    _parity(_truncated_never_subsumes, rels)


# -------------------------------------------------------- canonical keys


def _signature_matrix(L, rel):
    Q = L.Q
    s = L.vd.connect(rel, _cfg(L))
    schema = s.schema
    aggs = (Q.AggSpec("AVG", 0),)
    spellings = [
        Q.AggQuery(aggs, (Q.NumRange(0, 2.0, 8.0), Q.CatIn(0, (1, 3, 2)))),
        Q.AggQuery(aggs, (Q.CatIn(0, (3, 2, 1)), Q.NumRange(0, 2.0, 8.0))),
        Q.AggQuery(aggs, (Q.NumRange(0, 2.0, 8.0), Q.NumRange(0, 2.0, 8.0),
                          Q.CatIn(0, (2, 1, 3, 1)))),
        Q.AggQuery(aggs, (Q.NumRange(0, 0.0, 8.0), Q.NumRange(0, 2.0, 10.0),
                          Q.CatIn(0, (1, 2, 3)))),
    ]
    digests = {L.QuerySignature.from_query(schema, q).digest()
               for q in spellings}
    assert len(digests) == 1
    wp = L.plan_workload(s.engine, spellings)
    for lp in wp.logical[1:]:
        np.testing.assert_array_equal(lp.rows, wp.logical[0].rows)
    assert wp.stats.n_snippets_fused == wp.logical[0].plan.snippets.n
    eq_then_range = Q.AggQuery(
        aggs, (Q.NumEq(0, 5.0), Q.NumRange(0, 2.0, 8.0)))
    range_then_eq = Q.AggQuery(
        aggs, (Q.NumRange(0, 2.0, 8.0), Q.NumEq(0, 5.0)))
    pair = [L.QuerySignature.from_query(schema, q).digest()
            for q in (eq_then_range, range_then_eq)]
    assert pair[0] == pair[1]
    boxes = [Q.predicates_to_arrays(schema, q.predicates)[0][0]
             for q in (eq_then_range, range_then_eq)]
    assert boxes[0] == boxes[1] == (5.0, 5.0)
    other = Q.AggQuery(aggs, (Q.NumRange(0, 2.0, 8.0),))
    other_digest = L.QuerySignature.from_query(schema, other).digest()
    assert other_digest not in digests
    # A wider sample of spellings, grouped and not, for the digests.
    more = [_q_grouped(L, s), _q_plain(L, s), _q_pin(L, s),
            s.query().sum("v0").count().where(L.vd.between("x1", 2.0, 7.0))
            .where(L.vd.one_of("c0", [2, 0])).build()]
    sigs = [L.QuerySignature.from_query(schema, q) for q in more]
    assert all(L.QuerySignature.from_jsonable(g.to_jsonable()) == g
               for g in sigs)
    return [sorted(digests), pair, other_digest,
            [g.digest() for g in sigs], [g.to_jsonable() for g in sigs]]


def test_signature_canonicalization_matrix(rels):
    """Equal BLAKE2b digest strings across the packages, on top of the
    reference test's canonicalization matrix."""
    _parity(_signature_matrix, rels)


# ---------------------------------------------------- quarantine / heal


def _quarantine_and_heal(L, rel):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q_cached, q_poison = _q_grouped(L, s), _q_plain(L, s)
    out = [s.execute(q_cached), s.execute(q_cached)]
    assert out[1].served_from == "cache:exact"
    s.drain()
    key = L.QuerySignature.from_query(s.schema, q_cached).digest()

    def entry_of(key):
        return next(e for e in s.intel.cache.state_dict(s.store)["entries"]
                    if e["key"] == key)

    before = entry_of(key)
    with L.faults.inject(L.faults.FaultSpec("ingest.apply", key=L.AVG_KEY,
                                            hits=(0,))):
        out.append(s.execute(q_poison))
        s.drain()
        assert L.AVG_KEY in s.stats()["health"]["quarantined"]
        during = s.execute(q_cached)
        assert during.served_from is None and during.degraded
        assert s.stats()["intel"]["quarantine_refused"] >= 1
        out.append(during)
    healed = s.heal()
    assert healed == {L.AVG_KEY: True}
    assert entry_of(key) == before
    refreshed = s.execute(q_cached)
    assert refreshed.served_from is None and not refreshed.degraded
    out += [refreshed, s.execute(q_cached)]
    assert out[-1].served_from == "cache:exact"
    s.drain()
    return out + [healed, s.stats()["intel"]]


def test_quarantine_refuses_and_cache_survives_heal_bitwise(rels):
    _parity(_quarantine_and_heal, rels)


# ---------------------------------------------------- checkpoint round-trip


def _checkpoint_roundtrip(L, rel, tmp):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_grouped(L, s)
    first = s.execute(q)
    s.drain()
    mgr = L.Manager(str(tmp / L.name))
    s.save(mgr, step=1)
    s2 = L.vd.connect(rel, _cfg(L), cache=True)
    s2.load(mgr, step=1)
    assert s2.stats()["intel"]["entries"] == 1
    got = s2.execute(q)
    assert got.served_from == "cache:exact"
    assert _cells(got) == _cells(first)
    s3 = L.vd.connect(rel, _cfg(L))
    s3.load(mgr, step=1)
    got_sd, want_sd = s3.engine.store.state_dict(), s.engine.store.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name in want_sd:
        for k in want_sd[name]:
            np.testing.assert_array_equal(got_sd[name][k], want_sd[name][k],
                                          err_msg=f"{name}/{k}")
    ans = s3.execute(q)
    assert ans.served_from is None and not ans.degraded
    s2.drain(), s3.drain()
    return [first, got, ans, s2.stats()["intel"]]


def test_cache_checkpoint_roundtrip(rels, tmp_path):
    _parity(_checkpoint_roundtrip, rels, tmp_path)


def _save_with_a_stale_entry(L, rel, path):
    """Three entries: one stale at save (q_a, made stale by q_b on the
    same synopsis), two fresh (q_b, and a COUNT on its own synopsis)."""
    s = L.vd.connect(rel, _cfg(L), cache=True)
    qs = [_q_grouped(L, s), _q_plain(L, s),
          s.query().count().where(L.vd.between("x0", 1.0, 9.0)).build()]
    answers = [s.execute(q) for q in qs]
    s.drain()
    s.save(L.Manager(str(path)), step=1)
    return qs, answers


def _load_and_repeat(L, rel, path, mgr_cls):
    s = L.vd.connect(rel, _cfg(L), cache=True)
    s.load(mgr_cls(str(path)), step=1)
    entries = s.intel.cache.state_dict(s.store)["entries"]
    fresh = [(e["key"], [g != -1 for _, g in e["gens"]]) for e in entries]
    # The fresh entries first: a miss re-records and moves its synopsis on.
    qs = [_q_plain(L, s),
          s.query().count().where(L.vd.between("x0", 1.0, 9.0)).build(),
          _q_grouped(L, s)]
    answers = [s.execute(q) for q in qs]
    s.drain()
    return fresh, answers


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_an_intel_checkpoint_cross_loads(rels, tmp_path, writer):
    """A checkpoint written by either package with its intel payload loads
    in both: the same entries re-license as fresh or stale, and the
    repeats are served alike (hits bitwise the writer's recorded cells)."""
    W = JAX if writer == "jax" else PORT
    _, written = _save_with_a_stale_entry(W, rels[writer], tmp_path)
    loaded = {L.name: _load_and_repeat(L, rels[L.name], tmp_path, W.Manager)
              for L in LIBS}
    assert loaded["torch"][0] == loaded["jax"][0]
    assert [ok for _, ok in loaded["torch"][0]] == [[False], [True], [True]]
    served = [[a.served_from for a in loaded[n][1]] for n in loaded]
    assert served[0] == served[1] == ["cache:exact", "cache:exact", None]
    for n in loaded:
        for got, want in zip(loaded[n][1][:2], written[1:]):
            assert _cells(got) == _cells(want)
    _same_records(loaded["torch"][1], loaded["jax"][1])


# ----------------------------------------------------------------- router


def _router(L, rel, async_ingest):
    tight = L.vd.ErrorBudget(target_rel_error=1e-9)  # never met
    cfg = L.IntelConfig(router=L.RouterConfig(probe_every=4,
                                              learn_ladder=False))
    s = L.vd.connect(rel, _cfg(L, async_ingest=async_ingest), cache=cfg)
    twin = L.vd.connect(
        rel, _cfg(L, async_ingest=async_ingest),
        cache=L.IntelConfig(router=L.RouterConfig(route_switching=False,
                                                  learn_ladder=False)))
    los = [1.0 + 0.25 * i for i in range(8)]  # distinct: no cache hits
    out, routes = [], []
    for lo in los:
        q = s.query().avg("v0").where(L.vd.between("x0", lo, 9.5)).build()
        before = dict(s.stats()["intel"]["routes"])
        a, w = s.execute(q, tight), twin.execute(q, tight)
        after = s.stats()["intel"]["routes"]
        routes.append(next(r for r in after if after[r] != before[r]))
        # Both exhaust the budget: "scan" is bitwise the always-improve
        # engine's full-budget answer.
        assert a.batches_used == w.batches_used == 4
        assert _cells(a) == _cells(w)
        out += [a, w]
    st = s.stats()["intel"]
    assert st["routes"]["scan"] > 0 and st["routes"]["improve"] >= 2
    assert twin.stats()["intel"]["routes"]["scan"] == 0
    fb = max(st["router"]["expected_batches"])
    assert st["router"]["expected_batches"][fb] == 4.0
    s.drain(), twin.drain()
    return out + [routes, st]


def test_router_learns_scan_route_bitwise(rels):
    """The reference (synchronous ingest) and the port under both ingest
    modes take the same routes, and the port's answers are bitwise alike
    in both modes."""
    want = _router(JAX, rels["jax"], False)
    runs = {mode: _router(PORT, rels["torch"], mode) for mode in (True,
                                                                  False)}
    for got in runs.values():
        _same_records(got, want)
    for a, b in zip(runs[True][:-2], runs[False][:-2]):
        assert _cells(a) == _cells(b) and a.batches_used == b.batches_used
    routes = runs[True][-2]
    # Cold start: the first query routes "improve" (the engine without a
    # router); once E[batches] has learned the full budget the router
    # flips to "scan", and the deterministic probe re-measures "improve".
    assert routes[0] == "improve" and "scan" in routes
    assert routes.count("improve") >= 2


def _ladder(L, rel):
    B = _budget(L)
    cfg = L.IntelConfig(router=L.RouterConfig(ladder_every=3))
    s = L.vd.connect(rel, _cfg(L), cache=cfg)
    plain = L.vd.connect(rel, _cfg(L))
    qs = [s.query().avg("v0").where(L.vd.between("x0", 1.0 + 0.5 * i, 9.0))
          .group_by("c0").build() for i in range(4)]
    out = []
    for q in qs:
        a, w = s.execute(q, B), plain.execute(q, B)
        assert _cells(a) == _cells(w)
        out += [a, w]
    floors = s.stats()["intel"]["router"]["learned_floors"]
    assert floors is not None
    assert s.config.min_q_bucket == floors[0]
    assert all(syn.min_q_bucket == floors[0]
               for _, syn in s.store.items())
    fresh = s.query().sum("v0").where(L.vd.between("x1", 2.0, 7.0)).build()
    a, w = s.execute(fresh, B), plain.execute(fresh, B)
    assert _cells(a) == _cells(w)
    s.drain(), plain.drain()
    return out + [a, w, tuple(floors), s.config.min_fill_bucket,
                  s.stats()["intel"]]


def test_learned_ladder_floors_are_answer_invariant(rels):
    _parity(_ladder, rels)


# --------------------------------------------------------- serving surface


def _explain_readonly(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_grouped(L, s)
    rep = s.explain(q, budget=B)
    assert rep.cache == "miss" and rep.route in ("improve", "scan")
    ans = s.execute(q, B)
    lookups = s.stats()["intel"]["lookups"]
    rep2 = s.explain(q, budget=B)
    assert rep2.cache == "exact" and rep2.route == "cache"
    assert "served from cache: exact → route=cache" in str(rep2)
    assert s.stats()["intel"]["lookups"] == lookups
    rep3 = s.explain(_q_pin(L, s), budget=B)
    assert rep3.cache == "subsumed"
    s.drain()
    return [ans, (rep.cache, rep.route), (rep2.cache, rep2.route),
            (rep3.cache, rep3.route), s.stats()["intel"]]


def test_explain_reports_cache_status_and_is_readonly(rels):
    _parity(_explain_readonly, rels)


def _stream_hit(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_plain(L, s)
    first = s.execute(q, B)
    rounds = list(s.stream(q, B))
    assert len(rounds) == 1 and rounds[0].final
    assert rounds[0].served_from == "cache:exact"
    assert _cells(rounds[0]) == _cells(first)
    s.drain()
    return [first, *rounds, s.stats()["intel"]]


def test_stream_short_circuits_on_hit(rels):
    _parity(_stream_hit, rels)


def _deadline_never_cached(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    q = _q_grouped(L, s)
    ans = s.execute(q, L.vd.ErrorBudget(deadline_s=0.0))
    assert ans.degraded and "deadline" in ans.degraded_reasons
    st = s.stats()["intel"]
    assert st["insertions"] == 0 and st["entries"] == 0
    full = s.execute(q, B)
    assert full.served_from is None and not full.degraded
    hit = s.execute(q, B)
    assert hit.served_from == "cache:exact" and not hit.degraded
    assert _cells(hit) == _cells(full)
    s.drain()
    return [ans, st, full, hit, s.stats()["intel"]]


def test_deadline_degraded_answer_never_cached_as_full_accuracy(rels):
    _parity(_deadline_never_cached, rels)


def _per_tenant(L, rel):
    B = _budget(L)
    s = L.vd.connect(rel, _cfg(L), cache=True)
    alice = L.Session.attached(s, tenant="alice")
    bob = L.Session.attached(s, tenant="bob")
    q = _q_grouped(L, s)
    a1 = alice.execute(q, B)
    b1 = bob.execute(q, B)
    assert b1.served_from == "cache:exact"
    assert _cells(b1) == _cells(a1)
    pt = s.stats()["intel"]["per_tenant"]
    assert pt["alice"] == {"lookups": 1, "hits": 0, "hit_rate": 0.0}
    assert pt["bob"] == {"lookups": 1, "hits": 1, "hit_rate": 1.0}
    s.execute(q, B)
    assert s.stats()["intel"]["per_tenant"] == pt
    state = s.intel.state_dict(s.store)
    fresh = L.vd.connect(rel, _cfg(L), cache=True)
    fresh.intel.load_state_dict(state, fresh.store)
    assert fresh.intel.telemetry.per_tenant == {
        "alice": {"lookups": 1, "hits": 0},
        "bob": {"lookups": 1, "hits": 1}}
    s.drain()
    return [a1, b1, pt, s.stats()["intel"]]


def test_per_tenant_intel_counters_and_roundtrip(rels):
    _parity(_per_tenant, rels)
