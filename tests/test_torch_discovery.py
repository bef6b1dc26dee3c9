"""Group discovery (``VerdictEngine._discover_groups_many``) against its
definition and the JAX reference (CPU).

The port marks each group-by probe's groups with the ``group_discovery``
kernel's plain version here (the kernel itself on the card:
``tests/test_torch_gpu.py``). Each case holds its answer, exactly, to

- a NumPy statement of the definition: the sorted distinct group tuples of
  the first sample batch's tuples that the query's COUNT probe admits
  (``lo − RANGE_EPS ≤ x ≤ hi + RANGE_EPS`` on every numeric dim, AND
  categorical membership), ``()`` where none, ``((),)`` without a
  group-by;
- the JAX reference engine's ``_discover_groups_many`` on the same
  relation, sample and queries.

Cases: group-by over 1, 2 and 3 columns in given and reversed order, a
probe that admits nothing, bounds on the ``RANGE_EPS`` edge, group-by and
plain queries mixed, one probe and 25, and both routes (a schema whose key
space passes the table bound, and a table bound cut so that the probes
whose tables no longer fit take the sorted route beside the table route).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro.aqp import queries as JQ  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro_torch.aqp import queries as Q  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.kernels import RANGE_EPS, launch_counts  # noqa: E402
from repro_torch.kernels.group_discovery import ops as gd_ops  # noqa: E402

SMALL = (4, 3, 5)  # key spaces up to 60: the table route
WIDE = (200, 181, 3)  # (0, 1) spans 36,200 keys: past the table bound
CFG = dict(sample_rate=0.2, n_batches=3, seed=1, capacity=24)


def _rel_kw(cats):
    return dict(seed=5, n_rows=6000, n_num=2, cat_sizes=cats, n_measures=1)


@functools.cache
def _engines(cats):
    """(reference, port) engines on the same relation and sample."""
    jr = jx_w.make_relation(**_rel_kw(cats))
    pr = pt_w.make_relation(**_rel_kw(cats), device="cpu")
    return (jx_engine.VerdictEngine(jr, jx_engine.EngineConfig(**CFG)),
            pt_engine.VerdictEngine(pr, pt_engine.EngineConfig(**CFG),
                                    device="cpu"))


def _to_reference(q):
    conv = {"NumRange": JQ.NumRange, "NumEq": JQ.NumEq, "CatEq": JQ.CatEq,
            "CatIn": JQ.CatIn}
    return JQ.AggQuery(
        aggs=tuple(JQ.AggSpec(a.kind, a.measure) for a in q.aggs),
        predicates=tuple(conv[type(p).__name__](**vars(p))
                         for p in q.predicates),
        groupby=q.groupby)


def _first_batch(eng):
    rows = eng.batches.batch_rows[0]
    sample = eng.batches.relation
    return (sample.num_normalized.numpy()[rows], sample.cat.numpy()[rows])


def _admitted(eng, q):
    """The definition's admitted tuples of ``q``'s COUNT probe."""
    x, codes = _first_batch(eng)
    probe = Q.decompose(eng.schema, Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                                               predicates=q.predicates))
    lo, hi, cat = (getattr(probe.snippets, f).numpy()[0]
                   for f in ("lo", "hi", "cat"))
    admit = ((x >= lo - RANGE_EPS) & (x <= hi + RANGE_EPS)).all(1)
    for k in range(codes.shape[1]):
        admit &= cat[k, codes[:, k]]
    return admit


def _definition(eng, q):
    if not q.groupby:
        return ((),)
    _, codes = _first_batch(eng)
    rows = codes[_admitted(eng, q)][:, list(q.groupby)]
    return tuple(sorted({tuple(int(v) for v in r) for r in rows}))


def _random(schema, n, groupbys, seed):
    """``n`` queries with random predicates, grouped in turn by
    ``groupbys`` (``()``: no group-by)."""
    qs = pt_w.make_workload(seed, schema, n, agg_kinds=("AVG", "COUNT"))
    return [dataclasses.replace(q, groupby=groupbys[i % len(groupbys)])
            for i, q in enumerate(qs)]


def _edge(eng):
    """Probes whose numeric range is one point half an epsilon beside one
    first-batch tuple's value (which admits that tuple alone) or two
    epsilons beside it (which admits none), above and below. The schema
    spans 10 raw units, so a raw step of 10 eps is one eps normalized."""
    x, _ = _first_batch(eng)
    raw = float(x[7, 0]) * 10.0
    qs = []
    for step in (0.5, 2.0):
        d = step * 10.0 * RANGE_EPS
        for at in (raw + d, raw - d):
            qs.append(Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                                 predicates=(Q.NumRange(0, at, at),),
                                 groupby=(1, 0)))
    return qs


CASES = {
    "one_column": (SMALL, lambda s, e: _random(s, 6, [(0,), (2,)], 1)),
    "two_columns": (SMALL, lambda s, e: _random(s, 6, [(0, 2)], 2)),
    "two_reversed": (SMALL, lambda s, e: _random(s, 6, [(2, 0)], 2)),
    "three_columns": (SMALL, lambda s, e: _random(s, 6, [(0, 1, 2)], 3)),
    "three_reversed": (SMALL, lambda s, e: _random(s, 6, [(2, 1, 0)], 3)),
    "admits_nothing": (SMALL, lambda s, e: [
        Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                   predicates=(Q.NumRange(0, 7.0, 7.0 + 1e-9),), groupby=(0,)),
        Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                   predicates=(Q.NumRange(0, 2.0, 8.0), Q.CatEq(1, 0),
                               Q.CatIn(1, (1, 2))), groupby=(1, 2)),
        *_random(s, 2, [(1,)], 4)]),
    "range_eps_edge": (SMALL, lambda s, e: _edge(e)),
    "mixed_plain": (SMALL, lambda s, e: _random(s, 9, [(), (1,), ()], 5)),
    "one_probe": (SMALL, lambda s, e: _random(s, 1, [(0, 1)], 6)),
    "many_probes": (SMALL, lambda s, e: _random(
        s, 30, [(0,), (1, 2), (), (2, 1, 0), (0, 2), (1,)], 7)),
    "sorted_route": (WIDE, lambda s, e: _random(
        s, 8, [(0, 1), (2,), (1, 0), (), (1, 2, 0)], 8)),
    "table_bound_cut": (SMALL, lambda s, e: _random(
        s, 20, [(0,), (0, 1, 2), (1, 2), (), (2,)], 9)),
}


def _check_routes(plan):
    """The tables lie back to back from 0, in probe order, within the
    bound; the sorted route's rows are numbered in probe order."""
    off, row = 0, 0
    for table_off, arg in plan.route.tolist():
        if table_off >= 0:
            assert table_off == off
            off += arg
        else:
            assert arg == row
            row += 1
    assert off == plan.n_keys <= gd_ops.GD_TABLE_KEYS
    assert row == plan.n_rows


@pytest.mark.parametrize("case", list(CASES))
def test_discovery_matches_definition_and_reference(case, monkeypatch):
    cats, make = CASES[case]
    jx_eng, pt_eng = _engines(cats)
    qs = make(pt_eng.schema, pt_eng)
    if case == "table_bound_cut":  # tables past 12 keys take the sorted route
        monkeypatch.setattr(gd_ops, "GD_TABLE_KEYS", 12)
    plan = gd_ops.discovery_plan([q.groupby for q in qs if q.groupby],
                                 cats)
    routes = {"sorted_route": True, "table_bound_cut": True}
    assert (plan.n_rows > 0) == routes.get(case, False)
    if case in ("sorted_route", "table_bound_cut"):
        assert plan.n_keys > 0  # the table route rides along
    _check_routes(plan)
    before = launch_counts()["group_discovery"]
    got = pt_eng._discover_groups_many(qs)
    assert launch_counts()["group_discovery"] == before  # the CPU: no launch
    assert got == [_definition(pt_eng, q) for q in qs]
    assert got == list(jx_eng._discover_groups_many(
        [_to_reference(q) for q in qs]))
    if case == "admits_nothing":
        assert got[0] == () and got[1] == ()
    if case == "range_eps_edge":  # the edge decides: tuple 7 alone, or none
        assert [int(_admitted(pt_eng, q).sum()) for q in qs] == [1, 1, 0, 0]
        assert [len(g) for g in got] == [1, 1, 0, 0]
