"""Improve plane of the PyTorch port against the JAX reference (CPU).

Covariance (``cov_matrix`` / ``cov_diag`` / ``prior_mean``) at rtol 1e-11,
the blocked inverse updates against the reference and a direct inverse,
validation with equal decisions, and the improve kernel's plain version:
float64 against the reference's ``gp_batch_infer_ref``, float32 against
the reference's Pallas kernel (interpret mode) at that test's own budget
(rtol 5e-3, atol 5e-5). Inside the port: async ingest equals sync ingest,
bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jx_cov  # noqa: E402
from repro.core import synopsis as jx_syn  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.core import validation as jx_val  # noqa: E402
from repro.kernels.gp_batch_infer import ops as jx_gp_ops  # noqa: E402
from repro.kernels.gp_batch_infer.ref import gp_batch_infer_ref as jx_gp_ref  # noqa: E402
from repro_torch.core import covariance as pt_cov  # noqa: E402
from repro_torch.core import synopsis as pt_syn  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.core import validation as pt_val  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.gp_batch_infer import ops as pt_gp_ops  # noqa: E402

F64 = torch.float64


def _schemas():
    kw = dict(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0), cat_sizes=(4, 3),
              n_measures=1)
    return jx_types.Schema(**kw), pt_types.Schema(**kw)


def _snippet_kw(rng, n, equality=False):
    ranges, cats = [], []
    for i in range(n):
        r = {}
        for d in range(2):
            a = rng.uniform(0, 0.6)
            r[d] = (a, a if equality and d == 0 else a + rng.uniform(0.05,
                                                                   0.4))
        ranges.append(r)
        cats.append({0: tuple(rng.choice(4, 2, replace=False))}
                    if i % 3 == 0 else {})
    return dict(agg=[i % 2 for i in range(n)], measure=0, num_ranges=ranges,
                cat_sets=cats)


def _pair(seed, n_i=9, n_j=13, equality=False):
    rng = np.random.default_rng(seed)
    jsch, psch = _schemas()
    kw_i = _snippet_kw(rng, n_i, equality)
    kw_j = _snippet_kw(rng, n_j, equality)
    log_ls = rng.normal(-1.0, 0.3, 2)
    log_s2, mu = float(rng.normal()), float(rng.normal())
    jp = jx_types.GPParams(jnp.asarray(log_ls), jnp.asarray(log_s2),
                           jnp.asarray(mu))
    pp = pt_types.GPParams(torch.as_tensor(log_ls), torch.tensor(log_s2,
                                                                 dtype=F64),
                           torch.tensor(mu, dtype=F64))
    return ((jx_types.make_snippets(jsch, **kw_i),
             jx_types.make_snippets(jsch, **kw_j), jp),
            (pt_types.make_snippets(psch, **kw_i),
             pt_types.make_snippets(psch, **kw_j), pp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covariance_matches_reference(seed):
    (ji, jj, jp), (pi, pj, pp) = _pair(seed)
    np.testing.assert_allclose(pt_cov.cov_matrix(pi, pj, pp).numpy(),
                               np.asarray(jx_cov.cov_matrix(ji, jj, jp)),
                               rtol=1e-11, atol=0)
    np.testing.assert_allclose(pt_cov.cov_diag(pi, pp).numpy(),
                               np.asarray(jx_cov.cov_diag(ji, jp)),
                               rtol=1e-11, atol=0)
    np.testing.assert_allclose(pt_cov.prior_mean(pj, pp).numpy(),
                               np.asarray(jx_cov.prior_mean(jj, jp)),
                               rtol=1e-11, atol=0)


def test_covariance_of_equality_predicates_matches_reference():
    """Zero-width (equality) ranges widen to 1e-6: the SE double integral's
    inclusion-exclusion then cancels ~12 digits, so the last-bit differences
    of ``erf``/``exp`` between the two libraries grow to ~1e-4 relative
    (measured 2.1e-4). Both packages share the cancellation; the budget
    here is 1e-3."""
    (ji, jj, jp), (pi, pj, pp) = _pair(3, equality=True)
    np.testing.assert_allclose(pt_cov.cov_matrix(pi, pj, pp).numpy(),
                               np.asarray(jx_cov.cov_matrix(ji, jj, jp)),
                               rtol=1e-3, atol=0)


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.parametrize("n,k", [(5, 1), (20, 3), (40, 8)])
def test_inverse_updates_match_reference_and_direct_inverse(n, k):
    rng = np.random.default_rng(n * 10 + k)
    full = _spd(rng, n + k)
    ainv = np.linalg.inv(full[:n, :n])
    cols, block = full[n:, :n], full[n:, n:]
    want = np.asarray(jx_syn.inv_append_block(
        jnp.asarray(ainv), jnp.asarray(cols), jnp.asarray(block)))
    got = pt_syn.inv_append_block(torch.as_tensor(ainv),
                                  torch.as_tensor(cols),
                                  torch.as_tensor(block))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    direct = torch.linalg.inv(torch.as_tensor(full))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-8,
                               atol=1e-10)
    pos = sorted(rng.choice(n + k, k, replace=False))
    keep = np.setdiff1d(np.arange(n + k), pos)
    want_d = np.asarray(jx_syn.inv_delete_block(jnp.asarray(want), pos))
    got_d = pt_syn.inv_delete_block(got, pos)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-9, atol=1e-11)
    direct_d = torch.linalg.inv(torch.as_tensor(full[np.ix_(keep, keep)]))
    np.testing.assert_allclose(got_d.numpy(), direct_d.numpy(), rtol=1e-8,
                               atol=1e-10)


def test_inv_append_block_refuses_a_non_positive_schur_complement():
    """Rounding can leave the computed Schur complement of a badly
    conditioned Sigma with an eigenvalue <= 0. The reference clamps it to
    the jitter, which puts ~1e10 into the inverse; the port returns None so
    that the synopsis rebuilds the inverse from Sigma."""
    rng = np.random.default_rng(3)
    full = _spd(rng, 6)
    ainv = torch.as_tensor(np.linalg.inv(full[:4, :4]))
    cols = torch.as_tensor(full[4:, :4])
    schur = full[4:, 4:] - full[4:, :4] @ np.linalg.inv(full[:4, :4]) @ full[:4, 4:]
    block = torch.as_tensor(full[4:, 4:] - 1.5 * np.eye(2) * np.linalg.eigvalsh(
        schur).max())
    assert pt_syn.inv_append_block(ainv, cols, block) is None
    assert pt_syn.inv_append_block(ainv, cols,
                                   torch.as_tensor(full[4:, 4:])) is not None


def test_synopsis_rebuilds_the_inverse_when_an_update_is_refused(monkeypatch):
    """With every blocked update refused, the synopsis keeps Sigma^{-1} by
    full refactors: it answers as one whose updates succeed, to rounding."""
    _, sch = _schemas()
    rng_a, rng_b = np.random.default_rng(6), np.random.default_rng(6)
    a = pt_syn.Synopsis(sch, capacity=16, async_ingest=False,
                        device="cpu")
    b = pt_syn.Synopsis(sch, capacity=16, async_ingest=False,
                        device="cpu")
    batches = []
    for rng in (rng_a, rng_b):
        batches.append([(_random_batch(rng, sch, 5, pt_types),
                         rng.normal(1.0, 0.3, 5), rng.uniform(0.01, 0.05, 5))
                        for _ in range(5)])
    for batch in batches[0]:
        a.add(*batch)
    monkeypatch.setattr(pt_syn, "inv_append_block", lambda *args: None)
    for batch in batches[1]:
        b.add(*batch)
    assert a.n == b.n == 16 and not b.quarantined
    assert torch.isfinite(b._sigma_inv).all()
    torch.testing.assert_close(b._sigma_inv, a._sigma_inv, rtol=1e-8,
                               atol=1e-10)
    new = _random_batch(np.random.default_rng(9), sch, 4, pt_types)
    raw = pt_types.RawAnswer(torch.ones(4, dtype=F64),
                             torch.full((4,), 0.02, dtype=F64))
    torch.testing.assert_close(b.improve(new, raw).theta,
                               a.improve(new, raw).theta, rtol=1e-9, atol=0)


def test_validate_gives_equal_decisions():
    rng = np.random.default_rng(4)
    n = 64
    agg = rng.integers(0, 2, n).astype(np.int32)
    mt, rt = rng.normal(0, 1, n), rng.normal(0, 1, n)
    mb, rb = rng.uniform(0.01, 1, n), rng.uniform(0.0, 1, n)
    want = jx_val.validate(*map(jnp.asarray, (agg, mt, mb, rt, rb)))
    got = pt_val.validate(*map(torch.as_tensor, (agg, mt, mb, rt, rb)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gp_inputs(q, c, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, c))
    sinv = a @ a.T / c + np.eye(c)
    k = rng.normal(0, 0.1, (q, c))
    alpha = rng.normal(0, 1, (c,))
    kappa2 = np.einsum("qc,cd,qd->q", k, sinv, k) + rng.uniform(0.05, 0.5, q)
    mu, rawt = rng.normal(0, 1, (q,)), rng.normal(0, 1, (q,))
    rawb = rng.uniform(0.0, 0.3, (q,))
    rawb[0] = 0.0  # the exact-raw branch
    return k, sinv, alpha, kappa2, mu, rawt, rawb


@pytest.mark.parametrize("q,c", [(1, 16), (64, 128), (100, 300)])
def test_gp_plain_version_matches_reference(q, c):
    inputs = _gp_inputs(q, c, q + c)
    want64 = jx_gp_ref(*map(jnp.asarray, inputs))
    got64 = pt_gp_ops.gp_batch_infer(*map(torch.as_tensor, inputs))
    for g, w in zip(got64, want64):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11,
                                   atol=1e-15)
    f32 = [v.astype(np.float32) for v in inputs]
    want32 = jx_gp_ops.gp_batch_infer(*map(jnp.asarray, f32), tile_q=64,
                                      tile_c=128)
    got32 = pt_gp_ops.gp_batch_infer(*map(torch.as_tensor, f32),
                                     dtype=torch.float32)
    for g, w in zip(got32, want32):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-5)
    assert float(got64[0][0]) == inputs[5][0] and float(got64[1][0]) == 0.0


def _partition(ranges, n):
    """The distinct ``ranges`` tile [0, n) end to end, none overlapping."""
    ranges = sorted(set((r.start, r.stop) for r in ranges))
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (_, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(a < b for a, b in ranges)
    return ranges


@pytest.mark.parametrize("c", [1, 31, 33, 257, 2000])
@pytest.mark.parametrize("q", [1, 8, 9, 128])
def test_gp_launch_plan(q, c):
    """K2's launch plan (the wrapper's, which the card's build reports as
    its own in the gpu tests): every (row, column, depth) element of the
    product lies in exactly one block, the scratch holds every partial, and
    the split of C is the same for every Q."""
    plan = pt_gp_ops.gp_plan(q, c)
    blocks = [plan.block(ct, s, rt) for ct in range(plan.n_col_tiles)
              for s in range(plan.n_splits) for rt in range(plan.n_row_tiles)]
    rows = _partition([b[0] for b in blocks], q)
    cols = _partition([b[1] for b in blocks], c)
    depth = _partition([b[2] for b in blocks], c)
    assert len(blocks) == plan.blocks == len(rows) * len(cols) * len(depth)
    assert len(set((b[0].start, b[1].start, b[2].start)
                   for b in blocks)) == len(blocks)
    assert plan.part_g == (q, len(cols), len(depth))
    assert plan.part_t == (q, len(cols))
    assert plan.scratch_elems == 3 * q + int(np.prod(plan.part_g)) + int(
        np.prod(plan.part_t))
    for other in (1, 8, 9, 33, 128, 300):
        assert pt_gp_ops.gp_plan(other, c).split == plan.split
        assert pt_gp_ops.gp_plan(other, c).n_splits == plan.n_splits
    assert plan.split % pt_gp_ops.GP_SPLIT_STEP == 0


def test_gp_wrapper_cpu_path_counts_no_launch_and_rejects_dtype():
    inputs = [torch.as_tensor(v) for v in _gp_inputs(4, 16, 0)]
    before = launch_counts()["gp_batch_infer"]
    pt_gp_ops.gp_batch_infer(*inputs)
    assert launch_counts()["gp_batch_infer"] == before
    with pytest.raises(TypeError):
        pt_gp_ops.gp_batch_infer(*inputs, dtype=torch.float16)


def _random_batch(rng, sch, n, lib):
    ranges = []
    for _ in range(n):
        r = {}
        for d in range(sch.n_num):
            a = rng.uniform(0, 0.6)
            r[d] = (a, a + rng.uniform(0.05, 0.4))
        ranges.append(r)
    return lib.make_snippets(sch, agg=0, measure=0, num_ranges=ranges)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_synopsis_improve_matches_reference(use_kernel):
    """Same adds, same new snippets: the port's Synopsis (capacity-bound,
    evicting) answers like the reference's, f64 at 1e-9 and f32 at 1e-3."""
    jsch, psch = _schemas()
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    js = jx_syn.Synopsis(jsch, capacity=24, async_ingest=False)
    ps = pt_syn.Synopsis(psch, capacity=24, async_ingest=False,
                         device="cpu")
    for step in range(5):
        n = 9
        for syn, rng, sch, lib in ((js, rj, jsch, jx_types),
                                   (ps, rp, psch, pt_types)):
            snips = _random_batch(rng, sch, n, lib)
            syn.add(snips, rng.normal(1.0, 0.3, n), rng.uniform(0.01, 0.05, n))
    assert ps.n == js.n == 24
    new_j = _random_batch(rj, jsch, 5, jx_types)
    new_p = _random_batch(rp, psch, 5, pt_types)
    raw = np.random.default_rng(1).normal(1.0, 0.2, 5)
    want = js.improve(new_j, jx_types.RawAnswer(jnp.asarray(raw),
                                                jnp.full(5, 0.02)),
                      use_kernel=use_kernel)
    got = ps.improve(new_p, pt_types.RawAnswer(torch.as_tensor(raw),
                                               torch.full((5,), 0.02,
                                                          dtype=F64)),
                     use_kernel=use_kernel)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    rtol = 1e-3 if use_kernel else 1e-9
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=rtol)
    np.testing.assert_allclose(got.beta2.numpy(), np.asarray(want.beta2),
                               rtol=rtol)


def test_async_ingest_matches_sync_bitwise():
    """Interleaved add/improve through the ingest thread gives bitwise the
    same model state and answers as synchronous ingestion."""
    _, sch = _schemas()
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    a = pt_syn.Synopsis(sch, capacity=32, async_ingest=True,
                        device="cpu")
    b = pt_syn.Synopsis(sch, capacity=32, async_ingest=False,
                        device="cpu")
    for step in range(10):
        last = []
        for syn, rng in ((a, rng_a), (b, rng_b)):
            n = 3 + step % 3
            syn.add(_random_batch(rng, sch, n, pt_types),
                    rng.normal(1.0, 0.3, n), rng.uniform(0.01, 0.05, n))
            new = _random_batch(rng, sch, 4, pt_types)
            raw = pt_types.RawAnswer(torch.as_tensor(rng.normal(1.0, 0.3, 4)),
                                     torch.full((4,), 0.02, dtype=F64))
            imp = syn.improve(new, raw)
            last.append((imp.theta, imp.beta2))
        assert torch.equal(last[0][0], last[1][0])
        assert torch.equal(last[0][1], last[1][1])
    a.drain()
    assert a.n == b.n == 32  # evictions happened along the way
    assert torch.equal(a._sigma_inv, b._sigma_inv)
    np.testing.assert_array_equal(a._theta[: a.n], b._theta[: b.n])


def test_quarantine_and_heal_from_rows():
    """A failed apply quarantines (raw answers served), heal() rebuilds from
    the rows and replays the parked batch: equal to a never-failed one."""
    from repro_torch.ft import faults

    _, sch = _schemas()
    rng = np.random.default_rng(2)
    batches = [(_random_batch(rng, sch, 4, pt_types), rng.normal(1, 0.3, 4),
                rng.uniform(0.01, 0.05, 4)) for _ in range(3)]
    ok = pt_syn.Synopsis(sch, capacity=16, async_ingest=False,
                         device="cpu")
    sick = pt_syn.Synopsis(sch, capacity=16, async_ingest=False,
                           device="cpu")
    sick.name = "agg0-measure0"
    for b in batches:
        ok.add(*b)
    with faults.inject(faults.FaultSpec("ingest.apply", key=sick.name,
                                        hits=(0,))):
        for b in batches:
            sick.add(*b)
    assert sick.quarantined and sick.ingest_stats()["unapplied"] == 3
    new = _random_batch(rng, sch, 3, pt_types)
    raw = pt_types.RawAnswer(torch.ones(3, dtype=F64),
                             torch.full((3,), 0.02, dtype=F64))
    assert not bool(sick.improve(new, raw).accepted.any())
    with pytest.raises(pt_syn.SynopsisQuarantinedError):
        sick.state_dict()
    assert sick.heal()
    assert torch.equal(sick._sigma_inv, ok._sigma_inv)
    assert torch.equal(sick.improve(new, raw).theta, ok.improve(new, raw).theta)


def test_synopsis_default_device_is_cuda_and_fails_loudly_without_it():
    """``Synopsis(schema)`` is a public entry point: with no device given it
    runs on the card, and without one it raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, sch = _schemas()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_syn.Synopsis(sch)
