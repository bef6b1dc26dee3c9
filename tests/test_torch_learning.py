"""The port's learning slice against the JAX reference (CPU): the
SE-covariance kernel's plain version (K3), the NLL and its gradient, Adam,
``fit``, the data-append adjustment, and ``refit`` / ``apply_append``
through the engine and the facade.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances:
  - K3's plain version against the reference kernel (interpret mode) and
    its jnp oracle: f64 rtol 1e-10, f32 rtol 2e-5 (atol 1e-7), the
    reference's own ``test_kernels.py`` budget;
  - ``numeric_factors`` through the wrapper: bitwise the expression it
    replaced (``prod_k clamp(II_k, 0)``);
  - ``nll`` and its gradient: rtol 1e-9;
  - ``adam_minimize``: history and parameters at rtol 1e-12, non-finite
    steps at the same indices;
  - ``fit`` on the lengthscale-recovery setup (n = 80, 200 steps): history
    and fitted ``log_ls`` at rtol 1e-6 (measured: history 2.7e-9, ``log_ls``
    6.1e-13 relative), plus the reference test's own assertions;
  - append statistics: equal; adjusted answers: equal;
  - ``VerdictEngine.refit`` then ``apply_append`` on the same synopses:
    params at rtol 1e-9 and stored answers (theta, beta2) at rtol 1e-12
    after each, then the next queries at ``test_torch_engine.py``'s rtol
    1e-9 with equal decisions;
  - inside the port, ``Session.refit`` over a 4-shard ``Mesh`` answers
    bitwise like a local session.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import append as jx_append  # noqa: E402
from repro.core import covariance as jx_cov  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.core import learning as jx_learning  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.kernels.se_covariance.ops import se_cov_matrix as jx_se  # noqa: E402
from repro.kernels.se_covariance.ref import (  # noqa: E402
    se_cov_matrix_ref as jx_se_ref)
from repro.utils.optim import adam_minimize as jx_adam  # noqa: E402
import repro_torch.verdict as pvd  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.core import append as pt_append  # noqa: E402
from repro_torch.core import covariance as pt_cov  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import learning as pt_learning  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.se_covariance import ops as pt_se  # noqa: E402
from repro_torch.utils.optim import adam_minimize as pt_adam  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are small: one intra-op thread is several times faster
    than the default pool when the workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ K3
def _ranges(rng, n, l, dtype):
    lo = rng.uniform(0, 0.6, (n, l)).astype(dtype)
    hi = (lo + rng.uniform(0.05, 0.4, (n, l))).astype(dtype)
    return lo, hi


@pytest.mark.parametrize("ni,nj,l", [(8, 8, 1), (100, 30, 3), (128, 128, 2),
                                     (257, 64, 5), (1, 300, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se_cov_plain_version_matches_reference(ni, nj, l, dtype):
    rng = np.random.default_rng(ni * 1000 + nj + l)
    lo_i, hi_i = _ranges(rng, ni, l, dtype)
    lo_j, hi_j = _ranges(rng, nj, l, dtype)
    ls = rng.uniform(0.2, 1.2, (l,)).astype(dtype)
    norm_i = rng.uniform(0.5, 2.0, (ni,)).astype(dtype)
    norm_j = rng.uniform(0.5, 2.0, (nj,)).astype(dtype)
    sigma2 = 1.7
    arrays = (lo_i, hi_i, lo_j, hi_j, ls)
    before = launch_counts()["se_cov_matrix"]
    got = pt_se.se_cov_matrix(*(torch.as_tensor(a) for a in arrays), sigma2,
                              torch.as_tensor(norm_i), torch.as_tensor(norm_j))
    assert launch_counts()["se_cov_matrix"] == before  # CPU: no launch
    assert got.dtype == torch.as_tensor(lo_i).dtype
    kernel = jx_se(*(jnp.asarray(a) for a in arrays), sigma2,
                   jnp.asarray(norm_i), jnp.asarray(norm_j),
                   tile_i=64, tile_j=64)
    oracle = jax.jit(jx_se_ref)(
        *(jnp.asarray(a, jnp.float64) for a in arrays), sigma2,
        jnp.asarray(norm_i, jnp.float64), jnp.asarray(norm_j, jnp.float64))
    rtol = 2e-5 if dtype == np.float32 else 1e-10
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                                   atol=1e-7)


def _snippets(seed, n, cats=(3,), equality=False):
    """The same random AVG/FREQ snippets in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(agg=rng.integers(0, 2, n).tolist(), measure=[0] * n,
              num_ranges=[], cat_sets=[])
    for _ in range(n):
        r = {}
        for d in range(2):
            a = rng.uniform(0, 6)
            r[d] = (a, a) if equality and d == 0 else (a, a + rng.uniform(0.5, 3))
        kw["num_ranges"].append(r)
        kw["cat_sets"].append({0: tuple(sorted(set(
            rng.integers(0, cats[0], 2).tolist())))})
    jsch = jx_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                           cat_sizes=cats, n_measures=1)
    psch = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                           cat_sizes=cats, n_measures=1)
    return (jsch, jx_types.make_snippets(jsch, **kw),
            psch, pt_types.make_snippets(psch, **kw))


@pytest.mark.parametrize("equality", [False, True])
def test_numeric_factors_through_the_wrapper_is_the_expression_it_replaced(
        equality):
    _, _, _, b = _snippets(3, 40, equality=equality)
    p = pt_types.GPParams(torch.as_tensor([-0.7, 0.2], dtype=F64),
                          torch.tensor(0.3, dtype=F64),
                          torch.tensor(0.1, dtype=F64))
    num, vol_i, vol_j = pt_cov.numeric_factors(b, b[np.arange(17)], p)
    lo_i, hi_i, w_i = pt_cov.widened(b.lo, b.hi)
    lo_j, hi_j, w_j = lo_i[:17], hi_i[:17], w_i[:17]
    g = pt_cov.se_double_integral(lo_i[:, None, :], hi_i[:, None, :],
                                  lo_j[None, :, :], hi_j[None, :, :], p.ls)
    assert torch.equal(num, torch.clamp(g, min=0.0).prod(-1))
    assert torch.equal(vol_i, w_i.prod(-1)) and torch.equal(vol_j,
                                                            w_j.prod(-1))


# ------------------------------------------------------------ NLL, Adam, fit
def _params(log_ls, log_s2, mu):
    return (jx_types.GPParams(jnp.asarray(log_ls), jnp.asarray(log_s2),
                              jnp.asarray(mu)),
            pt_types.GPParams(torch.as_tensor(log_ls, dtype=F64),
                              torch.tensor(log_s2, dtype=F64),
                              torch.tensor(mu, dtype=F64)))


def test_nll_and_its_gradient_match_reference():
    _, jb, _, pb = _snippets(5, 30)
    rng = np.random.default_rng(6)
    theta = rng.normal(0.2, 0.5, 30)
    beta2 = rng.uniform(0.01, 0.05, 30)
    log_ls, log_s2, mu = np.array([-0.4, 0.3]), -0.2, 0.1

    def jloss(free):
        p = jx_types.GPParams(free["log_ls"], free["log_sigma2"],
                              jnp.asarray(mu))
        return jx_learning.nll(p, jb, jnp.asarray(theta), jnp.asarray(beta2))

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(
        {"log_ls": jnp.asarray(log_ls), "log_sigma2": jnp.asarray(log_s2)})
    ls_t = torch.tensor(log_ls, dtype=F64, requires_grad=True)
    s2_t = torch.tensor(log_s2, dtype=F64, requires_grad=True)
    got = pt_learning.nll(pt_types.GPParams(ls_t, s2_t,
                                            torch.tensor(mu, dtype=F64)),
                          pb, torch.as_tensor(theta), torch.as_tensor(beta2))
    g_ls, g_s2 = torch.autograd.grad(got, (ls_t, s2_t))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-9)
    np.testing.assert_allclose(_np(g_ls), np.asarray(jgrad["log_ls"]),
                               rtol=1e-9)
    np.testing.assert_allclose(float(g_s2), float(jgrad["log_sigma2"]),
                               rtol=1e-9)


def test_nll_of_a_matrix_that_is_not_positive_definite_is_nan():
    _, _, _, pb = _snippets(5, 12)
    _, pp = _params(np.zeros(2), 0.0, 0.0)
    beta2 = torch.full((12,), -10.0, dtype=F64)  # Σ + diag(β²) indefinite
    assert torch.isnan(pt_learning.nll(pp, pb, torch.zeros(12, dtype=F64),
                                       beta2))


def test_adam_matches_reference_with_a_non_finite_region():
    """The loss turns NaN (with an infinite gradient at the edge) once x0
    passes 0.6: from there every step is skipped, as in the reference."""
    c = np.array([1.0, -2.0])

    def jloss(p):
        return jnp.sum((p["x"] - c) ** 2) + jnp.sqrt(0.6 - p["x"][0])

    def ploss(p):
        return (torch.sum((p["x"] - torch.as_tensor(c)) ** 2)
                + torch.sqrt(0.6 - p["x"][0]))

    x0 = np.array([0.0, 0.0])
    jp, jh = jx_adam(jloss, {"x": jnp.asarray(x0)}, steps=40, lr=0.05)
    pp, ph = pt_adam(ploss, {"x": torch.as_tensor(x0)}, steps=40, lr=0.05)
    jh = np.asarray(jh)
    assert np.isnan(jh).any() and np.isfinite(jh[:5]).all()
    np.testing.assert_array_equal(np.isnan(ph.numpy()), np.isnan(jh))
    ok = np.isfinite(jh)
    np.testing.assert_allclose(ph.numpy()[ok], jh[ok], rtol=1e-12)
    np.testing.assert_allclose(_np(pp["x"]), np.asarray(jp["x"]), rtol=1e-12)


def test_fit_recovers_lengthscales_like_reference():
    """``test_core_engine.py::test_learning_recovers_lengthscales`` in both
    packages: same history and fitted lengthscales, and the reference
    test's own assertions on the port's fit."""
    rng = np.random.default_rng(0)
    jsch = jx_types.Schema(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0),
                           cat_sizes=(), n_measures=1)
    psch = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0),
                           cat_sizes=(), n_measures=1)
    true = jx_types.GPParams(log_ls=jnp.log(jnp.asarray([0.15, 0.6])),
                             log_sigma2=jnp.log(2.0), mu=jnp.asarray(0.0))
    ranges = []
    for _ in range(80):
        r = {}
        for d in range(2):
            a = rng.uniform(0, 0.8)
            r[d] = (a, a + rng.uniform(0.02, 0.2))
        ranges.append(r)
    jb = jx_types.make_snippets(jsch, agg=jx_types.AVG, measure=0,
                                num_ranges=ranges)
    pb = pt_types.make_snippets(psch, agg=pt_types.AVG, measure=0,
                                num_ranges=ranges)
    k = np.array(jx_cov.cov_matrix(jb, jb, true))
    k[np.diag_indices(80)] = np.asarray(jx_cov.cov_diag(jb, true))
    chol = np.linalg.cholesky(k + 1e-10 * np.eye(80))
    beta = 0.05
    theta = chol @ rng.normal(size=80) + beta * rng.normal(size=80)
    jfit, jhist = jx_learning.fit(jb, jnp.asarray(theta),
                                  jnp.full((80,), beta**2), jsch, steps=200,
                                  lr=0.1)
    pfit, phist = pt_learning.fit(pb, torch.as_tensor(theta),
                                  torch.full((80,), beta**2, dtype=F64), psch,
                                  steps=200, lr=0.1)
    np.testing.assert_allclose(phist.numpy(), np.asarray(jhist), rtol=1e-6)
    np.testing.assert_allclose(_np(pfit.log_ls), np.asarray(jfit.log_ls),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pfit.log_sigma2),
                               float(jfit.log_sigma2), rtol=1e-12)
    ls = np.exp(_np(pfit.log_ls))
    assert float(phist[-1]) < float(phist[0])  # NLL decreased
    assert ls[0] < ls[1]
    assert 0.05 < ls[0] < 0.45
    assert ls[1] > 0.3


def test_analytic_sigma2_mu_matches_reference():
    _, jb, _, pb = _snippets(8, 25)
    theta = np.random.default_rng(9).normal(0.3, 0.2, 25)
    js2, jmu = jx_cov.analytic_sigma2_mu(jb, jnp.asarray(theta))
    ps2, pmu = pt_cov.analytic_sigma2_mu(pb, torch.as_tensor(theta))
    np.testing.assert_allclose(float(ps2), float(js2), rtol=1e-12)
    np.testing.assert_allclose(float(pmu), float(jmu), rtol=1e-12)


# ------------------------------------------------------------------ append
def test_append_stats_and_adjusted_answers_equal_reference():
    rng = np.random.default_rng(11)
    old, new = rng.normal(1.0, 2.0, (500, 2)), rng.normal(1.8, 2.5, (300, 2))
    js = jx_append.estimate_append_stats(old, new, 10_000, 2_000)
    ps = pt_append.estimate_append_stats(torch.as_tensor(old),
                                         torch.as_tensor(new), 10_000, 2_000)
    np.testing.assert_array_equal(ps.mu, js.mu)
    np.testing.assert_array_equal(ps.eta2, js.eta2)
    assert ps.frac == js.frac
    theta, beta2 = rng.normal(size=40), rng.uniform(0.01, 0.1, 40)
    mea, agg = rng.integers(0, 2, 40), rng.integers(0, 2, 40)
    jt, jb2 = jx_append.adjust_answers(jnp.asarray(theta), jnp.asarray(beta2),
                                       jnp.asarray(mea), jnp.asarray(agg), js)
    pt, pb2 = pt_append.adjust_answers(
        torch.as_tensor(theta), torch.as_tensor(beta2), torch.as_tensor(mea),
        torch.as_tensor(agg), ps)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pb2.numpy(), np.asarray(jb2))


# ------------------------------------------------------- engine and facade
REL_KW = dict(seed=10, n_rows=8_000, n_num=2, cat_sizes=(), n_measures=1,
              noise=0.1)
CFG_KW = dict(sample_rate=0.2, n_batches=4, capacity=64, seed=0)


def _to_reference_query(q):
    from repro.aqp import queries as JQ

    conv = {"NumRange": JQ.NumRange, "NumEq": JQ.NumEq, "CatEq": JQ.CatEq,
            "CatIn": JQ.CatIn}
    preds = tuple(conv[type(p).__name__](**vars(p)) for p in q.predicates)
    aggs = tuple(JQ.AggSpec(a.kind, a.measure) for a in q.aggs)
    return JQ.AggQuery(aggs=aggs, predicates=preds, groupby=q.groupby)


def _assert_synopses_close(jeng, peng, rtol):
    assert sorted(jeng.store.keys()) == sorted(peng.store.keys())
    for key, jsyn in jeng.store.items():
        psyn = peng.store.get(key)
        for f in ("log_ls", "log_sigma2", "mu"):
            np.testing.assert_allclose(_np(getattr(psyn.params, f)),
                                       np.asarray(getattr(jsyn.params, f)),
                                       rtol=rtol, err_msg=f"{key} {f}")
        np.testing.assert_allclose(_np(psyn.theta()), np.asarray(jsyn.theta()),
                                   rtol=1e-12, err_msg=f"{key} theta")
        np.testing.assert_allclose(_np(psyn.beta2()), np.asarray(jsyn.beta2()),
                                   rtol=1e-12, err_msg=f"{key} beta2")


def _assert_answers_close(pres, jres):
    for got, want in zip(pres, jres):
        assert got.batches_used == want.batches_used
        for c, w in zip(got.cells, want.cells):
            np.testing.assert_allclose(c["estimate"], w["estimate"], rtol=1e-9)
            np.testing.assert_allclose(c["beta2"], w["beta2"], rtol=1e-9)
        np.testing.assert_array_equal(_np(got.snippet_answer.accepted),
                                      np.asarray(want.snippet_answer.accepted))


def test_engine_refit_and_apply_append_match_reference():
    """``test_core_engine.py::test_append_adjustment_keeps_bounds_valid``'s
    set-up in both packages: the port's engine warms up and hands its
    synopses to the reference engine (``load_synopses_state_dict``; the
    warm-up itself is held to the reference in ``test_torch_engine.py``).
    Both ``refit``, take a drifted append on every synopsis, and answer the
    next queries."""
    jrel = jx_w.make_relation(**REL_KW)
    prel = pt_w.make_relation(**REL_KW, device="cpu")
    jeng = jx_engine.VerdictEngine(jrel, jx_engine.EngineConfig(**CFG_KW))
    peng = pt_engine.VerdictEngine(prel, pt_engine.EngineConfig(**CFG_KW),
                                   device="cpu")
    qs = pt_w.make_workload(7, prel.schema, 27, agg_kinds=("AVG", "COUNT"),
                            cat_pred_prob=0.0)
    peng.execute_many(qs[:24])
    jeng.load_synopses_state_dict(peng.synopses_state_dict())
    assert min(s.n for s in peng.store.values()) >= 3  # every key refits
    jeng.refit(steps=20)
    peng.refit(steps=20)
    _assert_synopses_close(jeng, peng, rtol=1e-9)
    # Append 20% new rows with +0.8 shifted measure values.
    extra = prel.take(np.arange(1_600))
    stats = pt_append.estimate_append_stats(
        prel.measures[:500], extra.measures[:500] + 0.8, prel.cardinality,
        extra.cardinality)
    jstats = jx_append.estimate_append_stats(
        np.asarray(jrel.measures[:500]),
        np.asarray(jrel.measures[:500]) + 0.8, jrel.cardinality, 1_600)
    assert stats.mu[0] == pytest.approx(0.8, abs=0.15)
    np.testing.assert_array_equal(stats.eta2, jstats.eta2)
    for key, psyn in peng.store.items():
        before = _np(psyn.beta2()).copy()
        psyn.apply_append(stats)
        jeng.store.get(key).apply_append(jstats)
        assert np.all(_np(psyn.beta2()) >= before)  # only inflate
    _assert_synopses_close(jeng, peng, rtol=1e-9)
    _assert_answers_close(
        peng.execute_many(qs[24:], max_batches=1),
        jeng.execute_many([_to_reference_query(q) for q in qs[24:]],
                          max_batches=1))


def test_refit_skips_quarantined_and_small_synopses():
    rel = pt_w.make_relation(**REL_KW, device="cpu")
    eng = pt_engine.VerdictEngine(rel, pt_engine.EngineConfig(**CFG_KW),
                                  device="cpu")
    eng.execute_many(pt_w.make_workload(7, rel.schema, 4, agg_kinds=("AVG",),
                                        cat_pred_prob=0.0))
    syn = next(iter(eng.store.values()))
    assert syn.n >= 3
    p0 = syn.params
    syn._mark_quarantined(RuntimeError("test"))
    assert syn.refit(steps=3) is p0
    syn.heal()
    syn.n, n = 2, syn.n
    assert syn.refit(steps=3) is p0
    syn.n = n
    assert syn.refit(steps=3) is not p0


def test_session_refit_over_a_mesh_is_bitwise_the_local_refit():
    rel = pt_w.make_relation(seed=0, n_rows=6_000, n_num=2, cat_sizes=(4,),
                             n_measures=1, lengthscale=0.4, noise=0.2,
                             device="cpu")
    cfg = pvd.EngineConfig(sample_rate=0.15, n_batches=4, capacity=128, seed=0)
    qs = pt_w.make_workload(1, rel.schema, 14,
                            agg_kinds=("AVG", "COUNT", "SUM"))
    out = []
    for kw in ({}, {"mesh": pvd.Mesh(("cpu",) * 4)}):
        sess = pvd.connect(rel, cfg, **kw)
        sess.execute_many(qs[:10])
        sess.refit(steps=15)
        budget = pvd.ErrorBudget(target_rel_error=0.05)
        answers = [sess.execute(q, budget) for q in qs[10:]]
        params = {k: tuple(_np(t) for t in (s.params.log_ls,
                                            s.params.log_sigma2, s.params.mu))
                  for k, s in sess.store.items()}
        out.append((answers, params))
    (la, lp), (ma, mp) = out
    assert lp.keys() == mp.keys()
    for k in lp:
        for a, b in zip(lp[k], mp[k]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(la, ma):
        assert a.batches_used == b.batches_used
        assert ([(c.estimate, c.beta2) for c in a.cells]
                == [(c.estimate, c.beta2) for c in b.cells])
