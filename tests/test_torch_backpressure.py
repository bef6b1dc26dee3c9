"""The port's async-ingest back-pressure and failure quarantine
(``repro_torch.core.synopsis``: the bounded ingest queue, shedding to
synchronous ingest, the high-water mark, quarantine and heal) against the
JAX reference's (CPU).

Every test of ``test_ingest_backpressure.py`` runs here as a scenario on a
``Synopsis`` or ``LocalSynopsisStore`` of each package, fed the same
batches (made from a seed with numpy), each held to the reference test's
own assertions. Then the two packages' records must agree: the stored raw
answers (``theta``, ``beta2``) and every count equal, Σ⁻¹ and α within
rtol 1e-9 (float64; the two packages' covariance builds differ in the last
bits, ROADMAP Queue 3). Telemetry that depends on how far an ingest thread
got (``high_water`` below its bound, ``shed_count``) is held by each
package's assertions, not compared.
"""
import time
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jx_engine  # noqa: E402
from repro.core import store as jx_store  # noqa: E402
from repro.core import synopsis as jx_synopsis  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import store as pt_store  # noqa: E402
from repro_torch.core import synopsis as pt_synopsis  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402

JAX = types.SimpleNamespace(
    name="jax", T=jx_types, S=jx_synopsis, store=jx_store, E=jx_engine,
    dev={}, tensor=jnp.asarray)
PORT = types.SimpleNamespace(
    name="torch", T=pt_types, S=pt_synopsis, store=pt_store, E=pt_engine,
    dev={"device": "cpu"}, tensor=torch.as_tensor)
LIBS = (JAX, PORT)


def _schema(L):
    return L.T.Schema(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0), cat_sizes=(4,),
                      n_measures=1)


def _ranges(rng, sch, n):
    ranges = []
    for _ in range(n):
        r = {}
        for d in range(sch.n_num):
            a = rng.uniform(0, 0.6)
            r[d] = (a, a + rng.uniform(0.05, 0.4))
        ranges.append(r)
    return ranges


def _batch(L, rng, sch, n, agg=None):
    agg = L.T.AVG if agg is None else agg
    return L.T.make_snippets(sch, agg=agg, measure=0,
                             num_ranges=_ranges(rng, sch, n))


def _adds(L, seed, n_batches=8, k=3):
    rng = np.random.default_rng(seed)
    sch = _schema(L)
    return sch, [
        (_batch(L, rng, sch, k), rng.normal(1.0, 0.3, k),
         rng.uniform(0.01, 0.05, k))
        for _ in range(n_batches)
    ]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _model(syn):
    """What a synopsis learned: its fill, stored answers, Σ⁻¹ and α."""
    syn.drain()
    return dict(n=syn.n, theta=_np(syn.theta()), beta2=_np(syn.beta2()),
                sigma_inv=_np(syn._sigma_inv), alpha=_np(syn._alpha))


def _same_model(got, want):
    assert got["n"] == want["n"]
    np.testing.assert_array_equal(got["theta"], want["theta"])
    np.testing.assert_array_equal(got["beta2"], want["beta2"])
    for k in ("sigma_inv", "alpha"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def _parity(scenario):
    """Run ``scenario(L)`` on both packages; its record is a list of
    models (compared as ``_same_model``) and plain values (equal)."""
    rec = {L.name: scenario(L) for L in LIBS}
    got, want = rec["torch"], rec["jax"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict) and "sigma_inv" in w:
            _same_model(g, w)
        else:
            assert g == w, (g, w)
    return rec


def _state_equal(got, want):
    for k in want:
        if k == "ingest_high_water":  # telemetry, not model state
            continue
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# --------------------------------------------------------------- bound


def _default_bound(L):
    syn = L.S.Synopsis(_schema(L), capacity=32, **L.dev)
    assert syn.max_pending == L.S.MAX_PENDING_DEFAULT
    stats = syn.ingest_stats()
    assert stats == {
        "max_pending": L.S.MAX_PENDING_DEFAULT, "high_water": 0,
        "shed_count": 0, "quarantined": False, "quarantine_reason": None,
        "unapplied": 0, "quarantine_count": 0,
    }
    return [stats]


def test_default_bound_and_idle_stats():
    _parity(_default_bound)


def _overload_sheds(L):
    sch, adds = _adds(L, seed=0, n_batches=8)
    syn = L.S.Synopsis(sch, capacity=64, max_pending=2, **L.dev)
    inner = syn._apply_add

    def slow(*args):
        time.sleep(0.05)
        inner(*args)

    syn._apply_add = slow  # bound before the lazy queue is created
    for b, th, b2 in adds:
        syn.add(b, th, b2)
    syn.drain()
    stats = syn.ingest_stats()
    assert stats["high_water"] <= 2  # the bound held
    assert stats["shed_count"] >= 1  # overload actually shed
    assert stats["max_pending"] == 2

    twin = L.S.Synopsis(sch, capacity=64, async_ingest=False, **L.dev)
    for b, th, b2 in adds:
        twin.add(b, th, b2)
    got, want = _model(syn), _model(twin)
    assert got["n"] == want["n"]
    for k in ("theta", "beta2", "sigma_inv", "alpha"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return [got]


def test_overload_sheds_to_sync_and_matches_synchronous_state():
    """With a tiny bound and a slowed-down apply, producers overrun the
    queue; the shed path (drain, then apply inline) keeps FIFO order, so
    the final state is bitwise a fully synchronous synopsis'."""
    _parity(_overload_sheds)


def _high_water_roundtrip(L):
    sch, adds = _adds(L, seed=1, n_batches=4)
    syn = L.S.Synopsis(sch, capacity=64, max_pending=2, **L.dev)
    for b, th, b2 in adds:
        syn.add(b, th, b2)
    sd = syn.state_dict()
    assert "ingest_high_water" in sd
    assert int(sd["ingest_high_water"]) == syn.ingest_high_water
    restored = L.S.Synopsis(sch, capacity=64, **L.dev)
    restored.load_state_dict(sd)
    assert restored.ingest_high_water == syn.ingest_high_water
    # The telemetry survives a second snapshot (checkpoint round trip).
    np.testing.assert_array_equal(restored.state_dict()["ingest_high_water"],
                                  sd["ingest_high_water"])
    # Checkpoints from before back-pressure (no key) still load.
    legacy = {k: v for k, v in sd.items() if k != "ingest_high_water"}
    fresh = L.S.Synopsis(sch, capacity=64, **L.dev)
    fresh.load_state_dict(legacy)
    assert fresh.ingest_high_water == 0
    return [_model(restored), _model(fresh)]


def test_high_water_mark_in_state_dict_roundtrip():
    _parity(_high_water_roundtrip)


def test_a_high_water_mark_crosses_packages():
    """A port snapshot's ``ingest_high_water`` loads in the reference and
    the reference's in the port."""
    snaps = {}
    for L in LIBS:
        sch, adds = _adds(L, seed=1, n_batches=4)
        syn = L.S.Synopsis(sch, capacity=64, max_pending=2, **L.dev)
        for b, th, b2 in adds:
            syn.add(b, th, b2)
        snaps[L.name] = (syn.state_dict(), syn.ingest_high_water)
    for L, other in ((PORT, "jax"), (JAX, "torch")):
        sd, hw = snaps[other]
        restored = L.S.Synopsis(_schema(L), capacity=64, **L.dev)
        restored.load_state_dict(sd)
        assert restored.ingest_high_water == hw


def _drain_semantics(L):
    sch, adds = _adds(L, seed=2, n_batches=3)
    syn = L.S.Synopsis(sch, capacity=64, max_pending=1, **L.dev)
    for b, th, b2 in adds:
        syn.add(b, th, b2)
    syn.drain()
    syn.drain()  # idempotent
    assert syn.n > 0
    assert syn.ingest_stats()["high_water"] <= 1
    return [_model(syn)]


def test_drain_semantics_unchanged():
    _parity(_drain_semantics)


# ----------------------------------------------------------- quarantine


def _raw(L, theta, beta2):
    return L.T.RawAnswer(L.tensor(np.asarray(theta, np.float64)),
                         L.tensor(np.asarray(beta2, np.float64)))


def _store_quarantine(L):
    rng = np.random.default_rng(11)
    sch = _schema(L)
    cfg = L.E.EngineConfig(capacity=64, async_ingest=True)
    store = L.store.LocalSynopsisStore(sch, cfg, **L.dev)
    avg_key, freq_key = (L.T.AVG, 0), (L.T.FREQ, 0)
    sick = store.for_key(avg_key)
    assert sick.name == L.store.state_key(avg_key)

    def boom(*args):
        raise ValueError("injected apply failure")

    sick._apply_add = boom
    avg_adds = [(_batch(L, rng, sch, 3), rng.normal(1.0, 0.3, 3),
                 rng.uniform(0.01, 0.05, 3)) for _ in range(2)]
    freq_adds = [(_batch(L, rng, sch, 3, L.T.FREQ), rng.uniform(10, 20, 3),
                  rng.uniform(0.01, 0.05, 3)) for _ in range(2)]
    for (b, th, b2), (fb, fth, fb2) in zip(avg_adds, freq_adds):
        store.record(b, _raw(L, th, b2))
        store.record(fb, _raw(L, fth, fb2))
    store.drain()  # never raises: the failure is quarantined per key
    sick_name = L.store.state_key(avg_key)
    assert list(store.quarantined()) == [sick_name]
    assert "injected apply failure" in store.quarantined()[sick_name]
    assert store.stats()["quarantined"] == store.quarantined()
    healthy = store.get(freq_key)
    assert not healthy.quarantined and healthy.n > 0

    # The sick key degrades to the raw floor and reports into ``health``.
    probe = _batch(L, rng, sch, 2)
    health = {}
    imp = store.improve_groups(probe, _raw(L, [1.0, 2.0], [0.3, 0.4]),
                               health=health)
    np.testing.assert_array_equal(_np(imp.theta), [1.0, 2.0])
    assert not bool(_np(imp.accepted).any())
    assert list(health) == [sick_name]

    # The healthy key still improves through the same store call.
    fhealth = {}
    fimp = store.improve_groups(_batch(L, rng, sch, 2, L.T.FREQ),
                                _raw(L, [12.0, 13.0], [0.3, 0.4]),
                                health=fhealth)
    assert fhealth == {}

    # Checkpointing skips the sick key with a warning.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sd = store.state_dict()
    assert L.store.state_key(freq_key) in sd and sick_name not in sd
    assert any("quarantined" in str(w.message) for w in caught)

    # Heal: the parked batches replay in order; the healed synopsis is
    # bitwise one that never failed.
    del sick._apply_add
    assert store.heal() == {sick_name: True}
    assert store.quarantined() == {}
    twin = L.S.Synopsis(sch, capacity=64, async_ingest=False, **L.dev)
    for b, th, b2 in avg_adds:
        twin.add(b, th, b2)
    _state_equal(sick.state_dict(), twin.state_dict())
    return [_model(sick), _model(healthy),
            [float(v) for v in _np(fimp.theta)],
            [bool(v) for v in _np(fimp.accepted)]]


def test_store_quarantine_blast_radius_and_heal():
    """One key's failed apply quarantines THAT synopsis only: drain stays a
    plain barrier, the healthy key keeps improving, the sick key serves
    the raw floor, checkpointing skips it with a warning, and heal()
    restores bitwise parity with a twin that never failed."""
    rec = _parity(_store_quarantine)
    np.testing.assert_allclose(rec["torch"][2], rec["jax"][2], rtol=1e-9)


def _heal_from_last_good(L):
    rng = np.random.default_rng(12)
    sch = _schema(L)
    cfg = L.E.EngineConfig(capacity=64, async_ingest=True)
    store = L.store.LocalSynopsisStore(sch, cfg, **L.dev)
    key = (L.T.AVG, 0)
    adds = [(_batch(L, rng, sch, 3), rng.normal(1.0, 0.3, 3),
             rng.uniform(0.01, 0.05, 3)) for _ in range(4)]
    for b, th, b2 in adds[:2]:
        store.record(b, _raw(L, th, b2))
    good = store.state_dict()  # last-good checkpoint payload
    syn = store.get(key)

    def boom(*args):
        raise ValueError("apply failure after the checkpoint")

    syn._apply_add = boom
    for b, th, b2 in adds[2:]:
        store.record(b, _raw(L, th, b2))
    store.drain()
    assert store.quarantined()
    del syn._apply_add
    assert store.heal(states=good) == {L.store.state_key(key): True}
    twin = L.S.Synopsis(sch, capacity=64, async_ingest=False, **L.dev)
    for b, th, b2 in adds:
        twin.add(b, th, b2)
    _state_equal(syn.state_dict(), twin.state_dict())
    return [_model(syn)]


def test_heal_from_last_good_state_replays_parked_batches():
    """heal(states=...) restores the last-good snapshot, then replays the
    parked batches: the state equals applying every batch on a synopsis
    that never failed."""
    _parity(_heal_from_last_good)
