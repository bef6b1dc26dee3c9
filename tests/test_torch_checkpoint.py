"""The port's checkpoints (``repro_torch.ft.checkpoint``) and the engine's
and session's save / load / heal around them (CPU).

Mirrors the reference's checkpoint tests (``test_ft.py``,
``test_faults.py``, ``test_synopsis_store.py``) on the port, and holds the
on-disk format to the reference's: the same tree written by both packages
gives the same manifest and the same shard members, and a synopsis
checkpoint written by either package restores in the other with bitwise
equal arrays. Restored engines answer bitwise like the engine that saved.
"""
import json
import os
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.ft.checkpoint import CheckpointManager as JaxManager  # noqa: E402
import repro_torch.verdict as vd  # noqa: E402
from repro_torch.aqp import workload as W  # noqa: E402
from repro_torch.core.engine import EngineConfig, VerdictEngine  # noqa: E402
from repro_torch.core.store import (  # noqa: E402
    ShardedSynopsisStore,
    agg_key,
    state_key,
)
from repro_torch.core.types import AVG, to_numpy  # noqa: E402
from repro_torch.ft import faults  # noqa: E402
from repro_torch.ft.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointManager,
)

REL_KW = dict(seed=3, n_rows=6_000, n_num=2, cat_sizes=(4,), n_measures=1,
              lengthscale=0.4, noise=0.2)
CFG_KW = dict(sample_rate=0.15, n_batches=4, capacity=128, seed=0)


@pytest.fixture(scope="module")
def relation():
    return W.make_relation(**REL_KW, device="cpu")


def _engine(rel, mesh=None):
    store = None
    if mesh is not None:
        store = lambda schema, c: ShardedSynopsisStore(  # noqa: E731
            schema, c, mesh)
    return VerdictEngine(rel, EngineConfig(**CFG_KW), device="cpu",
                         store=store)


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            if k == "shard":  # where the key lived: a placement fact
                continue
            np.testing.assert_array_equal(np.asarray(got[name][k]),
                                          np.asarray(want[name][k]),
                                          err_msg=f"{name}/{k}")


def _assert_results_bitwise(r_a, r_b):
    assert len(r_a) == len(r_b)
    for a, b in zip(r_a, r_b):
        assert a.batches_used == b.batches_used
        assert a.cells == b.cells  # dict equality on floats == bitwise
        if a.snippet_answer is not None:
            for f in ("theta", "beta2", "accepted"):
                np.testing.assert_array_equal(
                    to_numpy(getattr(a.snippet_answer, f)),
                    to_numpy(getattr(b.snippet_answer, f)), err_msg=f)


# ----------------------------------------------------------------- manager
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones((2,), dtype=torch.int32),
                  {"c": torch.tensor(3.5, dtype=torch.float32)}]}
    mgr.save(5, tree, {"note": "x"})
    doubled = {"a": tree["a"] * 2, "b": [tree["b"][0] * 2,
                                         {"c": tree["b"][1]["c"] * 2}]}
    mgr.save_async(7, doubled, {"note": "y"})
    mgr.wait()
    assert mgr.all_steps() == [5, 7]
    restored, extra = mgr.restore(tree)  # latest
    torch.testing.assert_close(restored["a"], tree["a"] * 2, rtol=0, atol=0)
    assert restored["b"][0].dtype == torch.int32
    assert restored["b"][1]["c"].dtype == torch.float32
    assert float(restored["b"][1]["c"]) == 7.0
    assert extra["note"] == "y"
    r5, _ = mgr.restore(tree, step=5)
    torch.testing.assert_close(r5["a"], tree["a"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="missing keys"):
        mgr.restore({"zzz": torch.zeros(1)})


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.zeros((4,))}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    assert mgr.all_steps() == [2, 3]
    # a torn write (no COMMITTED marker) is invisible
    os.makedirs(tmp_path / "step_0000000009", exist_ok=True)
    assert mgr.latest_step() == 3


def test_checkpoint_write_fault_is_invisible_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep=5)
    tree = {"a": np.arange(4.0), "b": np.ones((2, 2))}
    mgr.save(0, tree)
    assert mgr.all_steps() == [0]
    with faults.inject(faults.FaultSpec("checkpoint.write", hits=(0,))):
        with pytest.raises(faults.InjectedFault):
            mgr.save(1, tree)
    # Torn write: no COMMITTED marker, step invisible, older step intact.
    assert mgr.all_steps() == [0]
    restored, _ = mgr.restore_blind()
    np.testing.assert_array_equal(restored["a"], tree["a"])
    mgr.save(1, tree)  # the seam recovers once the fault clears
    assert mgr.all_steps() == [0, 1]


def test_async_save_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep=5)
    tree = {"a": np.arange(3.0)}
    mgr.save(0, tree)
    with faults.inject(faults.FaultSpec("checkpoint.write", hits=(0,))):
        mgr.save_async(1, tree)
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            mgr.wait()  # inside the with: the daemon thread must see the plan
    assert mgr.all_steps() == [0]
    mgr.save_async(1, tree)  # exception was consumed; the manager recovers
    mgr.wait()
    assert mgr.all_steps() == [0, 1]


def test_corrupt_checkpoint_falls_back_to_earlier_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep=5)
    mgr.save(0, {"a": np.zeros(3)})
    mgr.save(1, {"a": np.ones(3)})
    # Bit-rot the newest shard: checksum verification must reject it and
    # restore must fall back to step 0 with a warning, not crash.
    shard = tmp_path / "c" / "step_0000000001" / "shard_0.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored, _ = mgr.restore_blind()
    np.testing.assert_array_equal(restored["a"], np.zeros(3))
    assert any("falling back" in str(w.message) for w in caught)
    # An injected read fault walks back the same way.
    mgr2 = CheckpointManager(str(tmp_path / "d"), keep=5)
    mgr2.save(0, {"a": np.zeros(3)})
    mgr2.save(1, {"a": np.ones(3)})
    with faults.inject(faults.FaultSpec("checkpoint.read", key="step_1",
                                        hits=(0,))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            restored, _ = mgr2.restore_blind()
    np.testing.assert_array_equal(restored["a"], np.zeros(3))
    assert any("falling back" in str(w.message) for w in caught)
    # No intact step left → the typed corruption error.
    with faults.inject(faults.FaultSpec("checkpoint.read", rate=1.0)):
        with pytest.raises(CheckpointCorruptError), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr2.restore_blind()


def test_on_disk_format_is_the_references(tmp_path):
    """The same tree written by both packages: equal manifests (checksums
    included, so the shard bytes are equal too) and equal shard members in
    the same order; each package reads the other's."""
    tree = {"z": np.arange(6.0).reshape(2, 3),
            "agg0-measure0": {"lo": np.ones((3, 2)), "cat": np.eye(2) > 0,
                              "order": np.arange(3, dtype=np.int64)},
            "b": [np.int32(4), {"c": np.float32(3.5)}, (np.zeros(2),)]}
    JaxManager(str(tmp_path / "jax")).save(4, jax_tree(tree), {"kind": "t"})
    CheckpointManager(str(tmp_path / "pt")).save(4, tree, {"kind": "t"})
    step = "step_0000000004"
    manifests = [json.loads((tmp_path / d / step / "manifest.json").read_text())
                 for d in ("jax", "pt")]
    assert manifests[0] == manifests[1]
    members = [zipfile.ZipFile(tmp_path / d / step / "shard_0.npz").namelist()
               for d in ("jax", "pt")]
    assert members[0] == members[1]
    for other in ("jax", "pt"):
        got, extra = CheckpointManager(str(tmp_path / other)).restore_blind()
        want, _ = JaxManager(str(tmp_path / other)).restore_blind()
        assert extra == {"kind": "t"}
        assert _flat(got).keys() == _flat(want).keys()
        for k, v in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[k], v)
            assert _flat(got)[k].dtype == v.dtype


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree(v) for v in tree)
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------- engine, session
def test_synopsis_checkpoint_roundtrip_makes_new_engine_smarter(relation,
                                                                tmp_path):
    """A fresh engine restores the synopses bit for bit and serves the same
    improved answers as the original (``test_ft.py``'s test on the port)."""
    eng = _engine(relation)
    train = W.make_workload(1, relation.schema, 12, agg_kinds=("AVG", "COUNT"))
    eng.execute_many(train)
    eng.refit(steps=20)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    eng.save_synopses(mgr, step=1)

    fresh = _engine(relation)  # simulated process restart
    extra = fresh.load_synopses(mgr)
    assert extra["kind"] == "verdict-synopses"
    assert fresh.store.keys() == eng.store.keys()
    for key, syn in eng.store.items():
        got = fresh.store.get(key).state_dict()
        want = syn.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str((key, k)))
    test_q = W.make_workload(2, relation.schema, 4, agg_kinds=("AVG",))
    r_old = [eng.execute(q, max_batches=2) for q in test_q]
    r_new = [fresh.execute(q, max_batches=2) for q in test_q]
    _assert_results_bitwise(r_old, r_new)
    accepted = sum(int(to_numpy(r.snippet_answer.accepted).sum())
                   for r in r_new)
    assert accepted > 0


@pytest.mark.parametrize("source,targets", [(4, (2, None)), (None, (4, 2))])
def test_checkpoint_replaces_onto_different_mesh_shape(relation, tmp_path,
                                                       source, targets):
    """A checkpoint re-places onto another shard count (or the local store)
    bit for bit, and the answers after restore are identical. ``None`` is
    the local store; an integer a ``Mesh`` listing the CPU that often."""
    def mesh(n):
        return None if n is None else vd.Mesh(("cpu",) * n)

    workload = W.make_workload(1, relation.schema, 14,
                               agg_kinds=("AVG", "COUNT", "SUM"),
                               cat_pred_prob=0.3)
    eng = _engine(relation, mesh(source))
    eng.execute_many(workload[:10])
    eng.refit(steps=15)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    eng.save_synopses(mgr, step=1)
    others = [_engine(relation, mesh(n)) for n in targets]
    for other in others:
        assert other.load_synopses(mgr)["kind"] == "verdict-synopses"
        assert other.store.keys() == eng.store.keys()
        _assert_states_equal(other.synopses_state_dict(),
                             eng.synopses_state_dict())
    r_orig = eng.execute_many(workload[10:], max_batches=2)
    for other in others:
        _assert_results_bitwise(r_orig,
                                other.execute_many(workload[10:],
                                                   max_batches=2))


def _queries(session):
    b = vd.between
    return [
        (session.query().avg("v0").where(b("x0", 2.0, 8.0))
         .group_by("c0").build()),
        session.query().count().where(b("x0", 1.0, 6.0)).build(),
        session.query().sum("v0").where(b("x1", 0.0, 7.0)).build(),
        session.query().avg("v0").where(b("x1", 3.0, 9.0)).build(),
    ]


def test_heal_restores_from_last_good_checkpoint(tmp_path):
    """Session.heal(manager) heals from the newest committed checkpoint and
    replays parked batches: the model state matches a never-failed twin
    (``test_faults.py``'s test on the port)."""
    rel = W.make_relation(seed=0, n_rows=4_000, n_num=2, cat_sizes=(4,),
                          n_measures=1, lengthscale=0.4, noise=0.2,
                          device="cpu")
    cfg = vd.EngineConfig(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
    avg_key = state_key(agg_key(AVG, 0))
    chaos = vd.connect(rel, cfg)
    twin = vd.connect(rel, cfg)
    qs = _queries(chaos)
    chaos.execute_many(qs)
    twin.execute_many(qs)
    twin.drain()  # its async applies must not race the armed plan below
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    chaos.save(mgr, step=0)
    with faults.inject(faults.FaultSpec("ingest.apply", key=avg_key,
                                        hits=(0,))):
        chaos.execute_many(qs)
        chaos.drain()  # quarantine lands while the plan is armed
    twin.execute_many(qs)
    assert avg_key in chaos.stats()["health"]["quarantined"]
    assert chaos.heal(mgr) == {avg_key: True}
    got_sd = chaos.engine.store.state_dict()
    want_sd = twin.engine.store.state_dict()
    for name in want_sd:
        for k in want_sd[name]:
            if k == "ingest_high_water":
                continue
            np.testing.assert_array_equal(got_sd[name][k], want_sd[name][k],
                                          err_msg=f"{name}/{k}")
    # heal(manager) with no committed checkpoint degrades to rebuild —
    # warn, not fail.
    with faults.inject(faults.FaultSpec("ingest.apply", key=avg_key,
                                        hits=(0,))):
        chaos.execute_many(qs)
    empty_mgr = CheckpointManager(str(tmp_path / "nothing"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        healed = chaos.heal(empty_mgr)
    assert healed == {avg_key: True}
    assert any("restore unavailable" in str(w.message) for w in caught)


def test_session_save_and_load(relation, tmp_path):
    sess = vd.connect(relation, vd.EngineConfig(**CFG_KW))
    sess.execute_many(W.make_workload(4, relation.schema, 6))
    mgr = CheckpointManager(str(tmp_path))
    sess.save(mgr, step=3)
    fresh = vd.connect(relation, vd.EngineConfig(**CFG_KW))
    assert fresh.load(mgr) == {"kind": "verdict-synopses"}
    _assert_states_equal(fresh.engine.synopses_state_dict(),
                         sess.engine.synopses_state_dict())


def test_an_intel_payload_is_ignored_with_a_warning(relation):
    """An engine without a workload-intelligence plane leaves a snapshot's
    ``"intel"`` payload out, as the reference does: the synopses restore
    exactly and nothing warns any more (an engine with a plane restores
    the payload: ``test_torch_intel.py``)."""
    eng = _engine(relation)
    eng.execute_many(W.make_workload(4, relation.schema, 4))
    state = dict(eng.synopses_state_dict(), intel={"cache": {}})
    fresh = _engine(relation)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh.load_synopses_state_dict(state)
    assert not [w for w in caught if "intel" in str(w.message)]
    state.pop("intel")
    _assert_states_equal(fresh.synopses_state_dict(), state)


# ------------------------------------------------------------- cross-load
@pytest.fixture(scope="module")
def trained_state(relation):
    eng = _engine(relation)
    eng.execute_many(W.make_workload(1, relation.schema, 12,
                                     agg_kinds=("AVG", "COUNT", "SUM")))
    eng.refit(steps=10)
    return eng.synopses_state_dict()


def test_a_reference_synopsis_checkpoint_restores_in_the_port(
        relation, trained_state, tmp_path):
    jrel = jx_w.make_relation(**REL_KW)
    jeng = jx_engine.VerdictEngine(jrel, jx_engine.EngineConfig(**CFG_KW))
    jeng.load_synopses_state_dict(trained_state)
    jeng.save_synopses(JaxManager(str(tmp_path)), step=2)
    peng = _engine(relation)
    assert peng.load_synopses(CheckpointManager(str(tmp_path))) == {
        "kind": "verdict-synopses"}
    _assert_states_equal(peng.synopses_state_dict(),
                         jeng.synopses_state_dict())


def test_a_port_synopsis_checkpoint_restores_in_the_reference(
        relation, trained_state, tmp_path):
    peng = _engine(relation)
    peng.load_synopses_state_dict(trained_state)
    peng.save_synopses(CheckpointManager(str(tmp_path)), step=2)
    jeng = jx_engine.VerdictEngine(jx_w.make_relation(**REL_KW),
                                   jx_engine.EngineConfig(**CFG_KW))
    assert jeng.load_synopses(JaxManager(str(tmp_path))) == {
        "kind": "verdict-synopses"}
    _assert_states_equal(jeng.synopses_state_dict(),
                         peng.synopses_state_dict())
