"""The port's ``connect``/``Session`` facade against the JAX reference's
``repro.verdict`` (CPU).

Both packages get the same relation and queries (made from a seed with
numpy) and run the same calls in the same order, locally and over a
4-shard mesh (the reference's from ``conftest``'s forced host devices, the
port's a ``Mesh`` listing the CPU four times). Tolerances:
  - answers of ``execute``, ``execute_many`` and every round of ``stream``:
    cells at rtol 1e-9 (float64), ``batches_used``, ``final`` and each
    improve's ``accepted`` equal;
  - ``explain``: its integer fields and the synopses' shard indices equal
    (its device strings differ by package);
  - ``stats()``: the scan telemetry (``blocks_evaluated``,
    ``tuples_scanned``, ``pad_rows``, ``n_shards``), the workload accounting
    and the store's per-shard occupancy equal;
  - inside the port, the mesh session is BITWISE the local session;
  - a reference ``ShardedSynopsisStore`` dump loads into the port, and both
    then answer alike.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import repro.verdict as jvd  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
import repro_torch.verdict as pvd  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.core.store import parse_state_key  # noqa: E402
from repro_torch.core.types import to_numpy  # noqa: E402

REL_KW = dict(seed=0, n_rows=6_000, n_num=2, cat_sizes=(4,), n_measures=1,
              lengthscale=0.4, noise=0.2)
CFG_KW = dict(sample_rate=0.15, n_batches=5, capacity=128, seed=0)
N_SHARDS = 4


def _queries(lib, schema):
    """The call list both packages run: a fused workload, single queries
    under a target, and a builder query."""
    w = (jx_w if lib is jvd else pt_w).make_workload(
        1, schema, 10, agg_kinds=("AVG", "COUNT", "SUM"), cat_pred_prob=0.3)
    return w


def _drive(sess, lib):
    """The same calls on either package's session. Returns the answers in
    order (a stream contributes every round) and each improve's
    ``accepted``."""
    accepted = []
    orig = sess.store.improve_groups

    def spy(*a, **kw):
        out = orig(*a, **kw)
        accepted.append(np.asarray(to_numpy(out.accepted)))
        return out

    sess.store.improve_groups = spy
    qs = _queries(lib, sess.schema)
    budget = lib.ErrorBudget(target_rel_error=0.05)
    answers = list(sess.execute_many(qs[:6]))
    answers += [sess.execute(q, budget) for q in qs[6:9]]
    built = (sess.query().avg("v0").count()
             .where(lib.between("x0", 1.0, 9.0)).group_by("c0"))
    answers += list(sess.stream(built, budget))
    answers += list(sess.stream(qs[9]))  # no target: every batch
    answers.append(sess.execute(sess.query().avg("v0"),
                                lib.ErrorBudget(max_batches=2)))
    sess.store.improve_groups = orig
    return answers, accepted


@pytest.fixture(scope="module")
def relations():
    return (jx_w.make_relation(**REL_KW),
            pt_w.make_relation(**REL_KW, device="cpu"))


@pytest.fixture(scope="module")
def runs(relations):
    """Local and mesh sessions of both packages, each driven once."""
    if jax.device_count() < N_SHARDS:
        pytest.skip(f"needs {N_SHARDS} host devices (conftest.py)")
    jrel, prel = relations
    meshes = {jvd: JaxMesh(np.array(jax.devices()[:N_SHARDS]), ("data",)),
              pvd: pvd.Mesh(("cpu",) * N_SHARDS)}
    out = {}
    for lib, rel in ((jvd, jrel), (pvd, prel)):
        for placed in ("local", "mesh"):
            kw = {"mesh": meshes[lib]} if placed == "mesh" else {}
            sess = lib.connect(rel, lib.EngineConfig(**CFG_KW), **kw)
            answers, accepted = _drive(sess, lib)
            sess.drain()
            out[(lib.__name__.split(".")[0], placed)] = (sess, answers,
                                                         accepted)
    return out


def _assert_answers_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.supported, a.batches_used, a.tuples_scanned, a.final,
                a.truncated_groups) == (b.supported, b.batches_used,
                                        b.tuples_scanned, b.final,
                                        b.truncated_groups)
        assert [(c.group, c.agg, c.kind) for c in a.cells] == \
            [(c.group, c.agg, c.kind) for c in b.cells]
        np.testing.assert_allclose([c.estimate for c in a.cells],
                                   [c.estimate for c in b.cells], rtol=1e-9)
        np.testing.assert_allclose([c.beta2 for c in a.cells],
                                   [c.beta2 for c in b.cells], rtol=1e-9)


@pytest.mark.parametrize("placed", ("local", "mesh"))
def test_answers_match_reference(runs, placed):
    """execute_many, execute under a target, every round of two streams:
    cells at rtol 1e-9, decisions equal."""
    _, jans, jacc = runs[("repro", placed)]
    _, pans, pacc = runs[("repro_torch", placed)]
    _assert_answers_close(pans, jans)
    assert len(pacc) == len(jacc)
    for a, b in zip(pacc, jacc):
        np.testing.assert_array_equal(a, b)
    assert sum(a.final for a in pans) < len(pans)  # the streams' rounds


def test_mesh_session_is_bitwise_the_local_session(runs):
    _, local, lacc = runs[("repro_torch", "local")]
    _, mesh, macc = runs[("repro_torch", "mesh")]
    assert [dataclasses.asdict(a) for a in mesh] == \
        [dataclasses.asdict(a) for a in local]
    assert all(np.array_equal(a, b) for a, b in zip(macc, lacc))


@pytest.mark.parametrize("placed", ("local", "mesh"))
def test_stats_match_reference(runs, placed):
    jst = runs[("repro", placed)][0].stats()
    pst = runs[("repro_torch", placed)][0].stats()
    for f in ("kind", "n_shards", "axis", "blocks_evaluated",
              "tuples_scanned", "pad_rows"):
        assert pst["scan"][f] == jst["scan"][f], f
    assert pst["workload"] == jst["workload"]
    assert pst["health"]["quarantined"] == jst["health"]["quarantined"] == {}
    js, ps = jst["store"], pst["store"]
    assert (ps["kind"], ps["n_shards"], ps["n_keys"]) == (
        js["kind"], js["n_shards"], js["n_keys"])
    for name, entry in js["keys"].items():
        mine = ps["keys"][name]
        assert (mine["n"], mine["capacity"], mine["shard"]) == (
            entry["n"], entry["capacity"], entry["shard"])
    if placed == "mesh":
        assert pst["scan"]["pad_rows"] > 0
        assert [(s["n_keys"], s["fill"]) for s in ps["shards"]] == \
            [(s["n_keys"], s["fill"]) for s in js["shards"]]
        assert pst["scan"]["evaluator"] == "sharded_mask+oracle_agg"


@pytest.mark.parametrize("placed", ("local", "mesh"))
def test_explain_matches_reference(runs, placed):
    reports = []
    for lib, name in ((jvd, "repro"), (pvd, "repro_torch")):
        sess = runs[(name, placed)][0]
        reports.append([
            sess.explain(sess.query().avg("v0").count()
                         .where(lib.between("x0", 2.0, 8.0))
                         .group_by("c0")),
            sess.explain(sess.query().sum("v0").where(lib.equals("c0", 1))),
            sess.explain(sess.query().avg("v0").where(lib.matches("%x%"))),
        ])
    for jrep, prep in zip(*reports):
        for f in ("supported", "unsupported_reason", "n_cells", "n_groups",
                  "truncated_groups", "n_snippets", "n_snippets_unique",
                  "dedup_ratio", "q_buckets", "fill_buckets",
                  "quarantined"):
            assert getattr(prep, f) == getattr(jrep, f), f
        assert prep.scan_placement == jrep.scan_placement
        shard = {k: v.split(":")[0] for k, v in prep.placement.items()}
        assert shard == {k: v.split(":")[0]
                         for k, v in jrep.placement.items()}
    rep = reports[1][0]
    assert rep.scan_placement == ("local" if placed == "local"
                                  else f"sharded:{N_SHARDS}xdata")
    assert f"scan={rep.scan_placement}" in str(rep)


def test_sharded_state_dict_and_reference_dump(runs, relations):
    """The port's sharded store tags each entry with its shard; a dump of
    the reference's sharded store loads into a port session, which then
    answers like a reference session loaded with the same dump."""
    psess = runs[("repro_torch", "mesh")][0]
    state = psess.store.state_dict()
    assert state
    for name, sd in state.items():
        assert int(sd["shard"]) == psess.store.shard_index(
            parse_state_key(name))
    jdump = runs[("repro", "mesh")][0].engine.synopses_state_dict()
    jrel, prel = relations
    jfresh = jvd.connect(jrel, jvd.EngineConfig(**CFG_KW))
    jfresh.engine.load_synopses_state_dict(jdump)
    pfresh = pvd.connect(prel, pvd.EngineConfig(**CFG_KW),
                         mesh=pvd.Mesh(("cpu",) * N_SHARDS))
    pfresh.engine.load_synopses_state_dict(jdump)
    loaded = pfresh.store.state_dict()
    assert loaded.keys() == jdump.keys()
    for name, sd in jdump.items():
        for k in ("lo", "hi", "cat", "agg", "measure", "theta", "beta2",
                  "stamp", "order"):
            np.testing.assert_array_equal(loaded[name][k], sd[k])
    qs = [jx_w.make_workload(7, jrel.schema, 3), pt_w.make_workload(
        7, prel.schema, 3)]
    _assert_answers_close(pfresh.execute_many(qs[1]),
                          jfresh.execute_many(qs[0]))


def test_builder_lowers_like_reference(relations):
    jrel, prel = relations
    built = []
    for lib, rel in ((jvd, jrel), (pvd, prel)):
        s = lib.connect(rel, lib.EngineConfig(**CFG_KW))
        built.append([
            s.query().avg("v0").count()
            .where(lib.between("x0", 2.0, 8.0), lib.equals("c0", 1),
                   lib.equals("x1", 0.5), lib.one_of("c0", [0, 3]))
            .group_by("c0").build(),
            s.query().min("v0").where(lib.matches("%x%"),
                                      lib.any_of(lib.equals("c0", 1)))
            .build(),
        ])
        with pytest.raises(KeyError, match="nope"):
            s.query().avg("nope").build()
        with pytest.raises(KeyError, match="ambiguous"):
            s.query().count().where(lib.equals(0, 2.5)).build()
        with pytest.raises(ValueError, match="no aggregates"):
            s.query().build()
    assert repr(built[1]) == repr(built[0])


def test_session_runs_on_the_relations_device(relations):
    _, prel = relations
    s = pvd.connect(prel, pvd.EngineConfig(**CFG_KW))
    assert s.engine.device == torch.device("cpu")
    assert s.explain(s.query().avg("v0")).scan_evaluator == "oracle"
    with pytest.raises(ValueError, match="first device"):
        pvd.connect(prel, pvd.EngineConfig(**CFG_KW),
                    mesh=pvd.Mesh(("meta", "cpu")))
    a = s.execute(s.query().count(), pvd.ErrorBudget(max_batches=2))
    assert a.batches_used == 2 and a.final
    assert a.value == pytest.approx(prel.cardinality, rel=0.1)


def test_verdict_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.verdict, "
            "repro_torch.kernels.range_mask_agg;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=src), timeout=120)
