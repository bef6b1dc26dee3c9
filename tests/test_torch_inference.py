"""The port's inference API (``repro_torch.core.inference``), the online
aggregation generator (``repro_torch.aqp.online``) and the small type helpers
against the JAX reference (CPU).

Mirrors ``test_core_inference.py``'s Eq. 11/12 and Theorem 1 tests and its
incremental linear algebra, and ``test_verdict_api.py``'s
``online_answers`` test, on the port; then feeds the same inputs (made
from a seed with numpy) to both packages. Tolerances: ``gp_posterior``,
``combine`` and ``model_based_answer`` at rtol 1e-12 (float64, the same
operations in the same order); ``chol_append_row`` at rtol 1e-12;
``online_answers``' partials and raw answers at rtol 1e-11 (the parity
policy's f64 reductions) with ``count`` and ``scanned`` exact;
``Schema.denormalize`` and ``ImprovedAnswer.error_bound`` at rtol 1e-15.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import proptest as pt  # noqa: E402
from repro.aqp import online as jx_online  # noqa: E402
from repro.aqp import queries as jx_q  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.core import inference as jx_inf  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro_torch.aqp import queries as pt_q  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.aqp.executor import (  # noqa: E402
    Partials,
    estimates_from_partials,
    eval_partials,
)
from repro_torch.aqp.online import online_answers  # noqa: E402
from repro_torch.core import covariance as C  # noqa: E402
from repro_torch.core import inference as I  # noqa: E402
from repro_torch.core.engine import EngineConfig, VerdictEngine  # noqa: E402
from repro_torch.core.synopsis import inv_append_block, inv_delete_block  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    AVG,
    GPParams,
    ImprovedAnswer,
    Schema,
    make_snippets,
)
from repro_torch.kernels import launch_counts  # noqa: E402

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _schema(l=2, cats=(4,)):
    return Schema(num_lo=(0.0,) * l, num_hi=(1.0,) * l, cat_sizes=cats,
                  n_measures=1)


def _random_batch(rng, sch, n, agg=AVG):
    ranges = []
    for _ in range(n):
        r = {}
        for d in range(sch.n_num):
            a = rng.uniform(0, 0.6)
            r[d] = (a, a + rng.uniform(0.05, 0.4))
        ranges.append(r)
    return make_snippets(sch, agg=agg, measure=0, num_ranges=ranges)


# ------------------------------------------------ the reference's tests


def test_eq11_12_matches_direct_conditional():
    """Verdict's O(n^2) forms == conditioning the full (n+2) joint (Eq. 4/5)."""
    rng = np.random.default_rng(3)
    sch = _schema()
    p = GPParams(log_ls=torch.log(_t([0.4, 0.7])),
                 log_sigma2=torch.log(_t(1.7)), mu=_t(0.9))
    n = 8
    past = _random_batch(rng, sch, n)
    new = _random_batch(rng, sch, 1)
    theta_past = rng.normal(1.0, 0.5, n)
    beta2_past = rng.uniform(0.01, 0.1, n) ** 2
    theta_new = float(rng.normal(1.0, 0.5))
    beta2_new = float(rng.uniform(0.05, 0.2) ** 2)

    kxx = C.cov_matrix(past, past, p).numpy()
    kxn = C.cov_matrix(past, new, p).numpy()[:, 0]
    knn = float(C.cov_diag(new, p).numpy()[0])
    mu_past = C.prior_mean(past, p).numpy()
    mu_new = float(C.prior_mean(new, p).numpy()[0])

    sig = np.zeros((n + 2, n + 2))
    sig[:n, :n] = kxx + np.diag(beta2_past)
    sig[:n, n] = sig[n, :n] = kxn
    sig[:n, n + 1] = sig[n + 1, :n] = kxn
    sig[n, n] = knn + beta2_new
    sig[n + 1, n + 1] = knn
    sig[n, n + 1] = sig[n + 1, n] = knn
    mu_vec = np.concatenate([mu_past, [mu_new, mu_new]])
    obs = np.concatenate([theta_past, [theta_new]])
    s11 = sig[: n + 1, : n + 1]
    k_col = sig[: n + 1, n + 1]
    mu_c = mu_new + k_col @ np.linalg.solve(s11, obs - mu_vec[: n + 1])
    var_c = sig[n + 1, n + 1] - k_col @ np.linalg.solve(s11, k_col)

    sigma_n = kxx + np.diag(beta2_past)
    sinv = np.linalg.inv(sigma_n)
    alpha = sinv @ (theta_past - mu_past)
    th, b2, _ = I.model_based_answer(
        _t(kxn[None, :]), _t([knn]), _t(sinv), _t(alpha), _t([mu_new]),
        _t([theta_new]), _t([beta2_new]))
    assert float(th[0]) == pytest.approx(mu_c, rel=1e-8)
    assert float(b2[0]) == pytest.approx(var_c, rel=1e-8)


@pt.given(n_cases=10, seed=7, n=pt.choice([1, 8, 20]), b=pt.floats(0.01, 0.5))
def test_theorem1_improved_error_never_larger(n, b):
    rng = np.random.default_rng(int(n * 1000 + b * 100))
    sch = _schema()
    p = GPParams.init(sch)
    past = _random_batch(rng, sch, n)
    new = _random_batch(rng, sch, 3)
    kxx = (C.cov_matrix(past, past, p).numpy()
           + np.diag(rng.uniform(0.01, 0.2, n)))
    sinv = np.linalg.inv(kxx)
    alpha = sinv @ rng.normal(0, 1, n)
    k = C.cov_matrix(new, past, p).numpy()
    kap = C.cov_diag(new, p).numpy()
    raw_beta2 = np.full(3, b**2)
    _, b2, _ = I.model_based_answer(
        _t(k), _t(kap), _t(sinv), _t(alpha), torch.zeros(3, dtype=F64),
        torch.zeros(3, dtype=F64), _t(raw_beta2))
    assert np.all(b2.numpy() <= raw_beta2 + 1e-15)


def test_exact_raw_answer_passthrough():
    th, b2 = I.combine(_t([5.0]), _t([1.0]), _t([3.0]), _t([0.0]))
    assert float(th[0]) == 3.0 and float(b2[0]) == 0.0


def test_incremental_inverse_matches_full():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 6))
    sig = a @ a.T + 6 * np.eye(6)
    inv = _t(np.linalg.inv(sig[:3, :3]))
    for i in range(3, 6):
        inv = inv_append_block(inv, _t(sig[i:i + 1, :i]),
                               _t(sig[i:i + 1, i:i + 1]), jitter=0.0)
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(sig), rtol=1e-8)
    keep = [0, 1, 3, 4, 5]
    inv_del = inv_delete_block(inv, [2])
    np.testing.assert_allclose(inv_del.numpy(),
                               np.linalg.inv(sig[np.ix_(keep, keep)]),
                               rtol=1e-7)


def test_chol_append_matches_full():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 5))
    sig = a @ a.T + 5 * np.eye(5)
    chol = _t(np.linalg.cholesky(sig[:2, :2]))
    for i in range(2, 5):
        chol = I.chol_append_row(chol, _t(sig[:i, i]), sig[i, i], jitter=0.0)
    np.testing.assert_allclose(chol.numpy(), np.linalg.cholesky(sig),
                               rtol=1e-8)


# ------------------------------------------------ against the reference


def _gp_inputs(seed, q_n=7, c_n=19):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c_n, c_n))
    sinv = np.linalg.inv(a @ a.T + c_n * np.eye(c_n))
    k = rng.uniform(0.0, 0.3, (q_n, c_n))
    kappa2 = rng.uniform(0.5, 1.5, q_n)
    alpha = rng.normal(size=c_n)
    mu = rng.normal(size=q_n)
    raw_theta = rng.normal(size=q_n)
    raw_beta2 = rng.uniform(0.0, 0.2, q_n)
    raw_beta2[0] = 0.0  # an exact raw answer
    return k, kappa2, sinv, alpha, mu, raw_theta, raw_beta2


@pytest.mark.parametrize("seed", [0, 1])
def test_inference_functions_match_the_reference(seed):
    k, kappa2, sinv, alpha, mu, raw_theta, raw_beta2 = _gp_inputs(seed)
    jx_prior, jx_g2 = jx_inf.gp_posterior(*map(jnp.asarray,
                                               (k, kappa2, sinv, alpha, mu)))
    prior, g2 = I.gp_posterior(*map(_t, (k, kappa2, sinv, alpha, mu)))
    np.testing.assert_allclose(prior.numpy(), np.asarray(jx_prior),
                               rtol=1e-12)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jx_g2), rtol=1e-12)
    jx_th, jx_b2 = jx_inf.combine(jx_prior, jx_g2, jnp.asarray(raw_theta),
                                  jnp.asarray(raw_beta2))
    th, b2 = I.combine(prior, g2, _t(raw_theta), _t(raw_beta2))
    np.testing.assert_allclose(th.numpy(), np.asarray(jx_th), rtol=1e-12)
    np.testing.assert_allclose(b2.numpy(), np.asarray(jx_b2), rtol=1e-12)
    args = (k, kappa2, sinv, alpha, mu, raw_theta, raw_beta2)
    want = jx_inf.model_based_answer(*map(jnp.asarray, args))
    before = launch_counts()["gp_batch_infer"]
    got = I.model_based_answer(*map(_t, args))
    assert launch_counts()["gp_batch_infer"] == before  # the CPU: no kernel
    for g, w in zip(got, want):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    # One home for the math: the blend the kernel's plain version computes.
    np.testing.assert_array_equal(got[0].numpy(), th.numpy())
    np.testing.assert_array_equal(got[1].numpy(), b2.numpy())


def test_model_based_answer_in_float32():
    args = [_t(a).to(torch.float32) for a in _gp_inputs(4)]
    got = I.model_based_answer(*args)
    want = I.model_based_answer(*[a.to(F64) for a in args])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_chol_append_row_matches_the_reference():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 6))
    sig = a @ a.T + 6 * np.eye(6)
    jchol = jnp.asarray(np.zeros((0, 0)))
    chol = torch.zeros((0, 0), dtype=F64)
    for i in range(6):
        jchol = jx_inf.chol_append_row(jchol, jnp.asarray(sig[:i, i]),
                                       sig[i, i])
        chol = I.chol_append_row(chol, _t(sig[:i, i]), sig[i, i])
        np.testing.assert_allclose(chol.numpy(), np.asarray(jchol),
                                   rtol=1e-12, atol=1e-300)


def test_denormalize_and_error_bound_match_the_reference():
    kw = dict(num_lo=(2.0, -5.0), num_hi=(10.0, 5.0), cat_sizes=(3,),
              n_measures=1)
    jsch, psch = jx_types.Schema(**kw), Schema(**kw)
    for dim in (0, 1):
        for v in (0.0, 0.25, 1.0):
            assert psch.denormalize(dim, v) == jsch.denormalize(dim, v)
            assert psch.denormalize(dim, psch.normalize(dim, 7.0)) == \
                pytest.approx(7.0, rel=1e-15)
    beta2 = np.array([0.0, 0.01, 2.5])
    pia = ImprovedAnswer(_t(beta2), _t(beta2), _t(beta2), _t(beta2),
                         torch.ones(3, dtype=torch.bool))
    jia = jx_types.ImprovedAnswer(*(jnp.asarray(beta2),) * 4,
                                  jnp.ones(3, bool))
    for delta in (0.9, 0.95):
        np.testing.assert_allclose(pia.error_bound(delta).numpy(),
                                   np.asarray(jia.error_bound(delta)),
                                   rtol=1e-15)


# ----------------------------------------------------- online_answers

REL_KW = dict(seed=0, n_rows=3_000, n_num=2, cat_sizes=(4,), n_measures=1,
              lengthscale=0.4, noise=0.2)
CFG_KW = dict(sample_rate=0.2, n_batches=4, capacity=128, seed=0)


def _online_query(Q):
    return Q.AggQuery(aggs=(Q.AggSpec("AVG", 0), Q.AggSpec("COUNT")),
                      predicates=(Q.NumRange(0, 2.0, 8.0),))


def test_online_answers_rides_the_shared_scan():
    """``online_answers`` is a thin generator over ``PhysicalPlan``: its
    raw answers and partials equal a hand-rolled unpadded accumulation
    bitwise, and the reference's within the parity policy."""
    rel = pt_w.make_relation(**REL_KW, device="cpu")
    eng = VerdictEngine(rel, EngineConfig(**CFG_KW), device="cpu")
    plan = pt_q.decompose(rel.schema, _online_query(pt_q))
    outs = list(online_answers(eng.batches, plan.snippets))
    assert len(outs) == eng.batches.n_batches
    acc = None
    for (raw, state), rows in zip(outs, eng.batches.batch_rows):
        block = eng.batches.relation.take(rows)
        part = eval_partials(block.num_normalized, block.cat,
                                 block.measures, plan.snippets)
        acc = part if acc is None else acc + part
        assert isinstance(state.partials, Partials)
        np.testing.assert_array_equal(state.partials.count.numpy(),
                                      acc.count.numpy())
        np.testing.assert_array_equal(state.partials.sums.numpy(),
                                      acc.sums.numpy())
        theta, beta2, _ = estimates_from_partials(acc, plan.snippets)
        np.testing.assert_array_equal(raw.theta.numpy(), theta.numpy())
        np.testing.assert_array_equal(raw.beta2.numpy(), beta2.numpy())
    assert outs[-1][1].batches_used == eng.batches.n_batches

    jrel = jx_w.make_relation(**REL_KW)
    jeng = jx_engine.VerdictEngine(jrel, jx_engine.EngineConfig(**CFG_KW))
    jplan = jx_q.decompose(jrel.schema, _online_query(jx_q))
    jouts = list(jx_online.online_answers(jeng.batches, jplan.snippets))
    assert len(jouts) == len(outs)
    for (raw, state), (jraw, jstate) in zip(outs, jouts):
        assert state.batches_used == jstate.batches_used
        np.testing.assert_array_equal(state.partials.count.numpy(),
                                      np.asarray(jstate.partials.count))
        assert float(state.partials.scanned) == float(jstate.partials.scanned)
        for got, want in ((state.partials.sums, jstate.partials.sums),
                          (state.partials.sumsq, jstate.partials.sumsq),
                          (raw.theta, jraw.theta), (raw.beta2, jraw.beta2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-11, atol=0)
