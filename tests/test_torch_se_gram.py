"""K3's Gram route and its saved-derivative gradient, on the CPU.

The card's Gram kernel evaluates each symmetric pair's antiderivatives once
and writes both entries; the card's backward reduces derivatives the
forward saved. Neither runs here, so these tests hold what they rest on:

  - the Gram kernel's launch plan (``se_cov_plan``, the pure-Python twin of
    the library's): every entry of an n x n matrix is written exactly once,
    from the antiderivatives of its own pair, at n in {1, 31, 32, 33, 2000}
    for l = 3 (the templated kernel's tiles) and at l = 9 and 12 (the
    kernel for any l's);
  - the plain antiderivative F(u; z) is bitwise even (its derivative too)
    over a grid holding 0, subnormals, erf's branch points and |u/z| > 6,
    and the plain erf bitwise odd, in float64 and float32;
  - ``numeric_factors(b, b)`` takes the Gram route and equals
    ``numeric_factors(b, copy of b)`` bitwise;
  - ``se_cov_derivs_ref`` (K and the derivatives D): K bitwise the plain
    forward; sum(G * D_k) within rtol 1e-12 of autograd of the plain
    forward (``se_cov_grad_ref``; another summation order) and within rtol
    1e-9 of ``jax.grad`` of the reference's ``se_cov_matrix_ref`` on the
    same numpy inputs;
  - on a CPU tensor the wrappers are their plain versions, bit for bit,
    and count no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.se_covariance.ref import (  # noqa: E402
    se_cov_matrix_ref as jx_se_ref)
from repro_torch.core import covariance as pt_cov  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.se_covariance import ops as pt_se  # noqa: E402
from repro_torch.kernels.se_covariance import ref as pt_ref  # noqa: E402

F64 = torch.float64


@pytest.mark.parametrize("n,l", [(1, 3), (31, 3), (32, 3), (33, 3),
                                 (2000, 3), (1, 9), (70, 9), (257, 9),
                                 (33, 12), (2000, 12)],
                         ids=["1", "31", "32", "33", "2000", "1-l9", "70-l9",
                              "257-l9", "33-l12", "2000-l12"])
def test_gram_plan_writes_every_entry_once_from_its_own_pair(n, l):
    """Up to l = 8 the templated Gram kernel's 32 x 32 tiles, above it the
    kernel for any l's 8 x 8 tiles."""
    plan = pt_se.se_cov_plan(n, l)
    assert plan.tile == (32 if l <= pt_se.SE_MAX_L else 8)
    t = -(-n // plan.tile)
    assert plan.n_tiles == t and plan.blocks == t * (t + 1) // 2
    tiles = [plan.tiles(b) for b in range(plan.blocks)]
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    count = np.zeros((n, n), np.int64)
    for b in range(plan.blocks):
        row, col, a, bb = plan.writes(b)
        # (row, col) is the pair (a, b) itself or, from the same
        # antiderivatives, its mirror (b, a).
        direct = (row == a) & (col == bb)
        mirror = (row == bb) & (col == a)
        assert np.all(direct | mirror)
        ti, tj = tiles[b]
        assert np.all(a // plan.tile == ti) and np.all(bb // plan.tile == tj)
        assert ti != tj or np.all(direct)
        np.add.at(count, (row, col), 1)
    assert np.all(count == 1)


def _even_grid(dtype, z):
    """u values whose u/z covers 0, subnormals, the smallest normal, erf's
    branch points and beyond (|u/z| > 6, where erf is 1), densely."""
    info = np.finfo(dtype)
    r = np.concatenate([
        [0.0, info.smallest_subnormal, 4 * info.smallest_subnormal,
         info.tiny, 2 * info.tiny],
        np.logspace(np.log10(float(info.tiny)), 2, 4000),
        np.linspace(0.0, 7.0, 70001),
        [0.84375, 1.0, 1.25, 2.857142857142857, 5.9, 6.0, 6.5, 10.0, 27.0,
         1e10],
    ]).astype(dtype)
    r = np.concatenate([r, np.nextafter(r, np.inf).astype(dtype),
                        np.nextafter(r, -np.inf).astype(dtype)])
    return np.abs(r) * dtype(z)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_antiderivative_is_bitwise_even(dtype):
    for z in (0.3, 0.77, 1.5):
        u = torch.as_tensor(_even_grid(dtype, z))
        zt = torch.tensor(z, dtype=u.dtype)
        assert torch.equal(pt_ref._antideriv(-u, zt), pt_ref._antideriv(u, zt))
        assert torch.equal(pt_ref._antideriv_dz(-u, zt),
                           pt_ref._antideriv_dz(u, zt))
        r = u / zt
        assert torch.equal(torch.special.erf(-r), -torch.special.erf(r))


def _batch(seed, n, equality):
    rng = np.random.default_rng(seed)
    sch = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                          cat_sizes=(3,), n_measures=1)
    ranges = []
    for _ in range(n):
        a, c = rng.uniform(0, 6, 2)
        ranges.append({0: (a, a) if equality else (a, a + rng.uniform(0.5, 3)),
                       1: (c, c + rng.uniform(0.5, 3))})
    return pt_types.make_snippets(
        sch, agg=rng.integers(0, 2, n).tolist(), measure=[0] * n,
        num_ranges=ranges,
        cat_sets=[{0: (int(rng.integers(0, 3)),)} for _ in range(n)])


@pytest.mark.parametrize("equality", [False, True])
def test_numeric_factors_of_a_batch_with_itself_takes_the_gram_route(
        equality, monkeypatch):
    b = _batch(11, 40, equality)
    p = pt_types.GPParams(torch.as_tensor([-0.7, 0.2], dtype=F64),
                          torch.tensor(0.3, dtype=F64),
                          torch.tensor(0.1, dtype=F64))
    calls = []
    gram = pt_se.se_cov_gram

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return gram(*a, **kw)

    monkeypatch.setattr(pt_se, "se_cov_gram", spy)
    num, vol_i, vol_j = pt_cov.numeric_factors(b, b, p)
    assert calls == [(40, 2)]
    copy = b[np.arange(b.n)]
    assert copy is not b
    want, want_i, want_j = pt_cov.numeric_factors(b, copy, p)
    assert len(calls) == 1  # a copy takes the general route
    assert torch.equal(num, want)
    assert torch.equal(vol_i, want_i) and torch.equal(vol_j, want_j)
    assert torch.equal(num, num.T)


def _se_inputs(seed, n_i, n_j, l, gram=False):
    rng = np.random.default_rng(seed)
    lo_i = rng.uniform(0, 0.6, (n_i, l))
    hi_i = lo_i + rng.uniform(0.05, 0.4, (n_i, l))
    norm_i = rng.uniform(0.5, 2.0, n_i)
    if gram:
        lo_j, hi_j, norm_j = lo_i, hi_i, norm_i
    else:
        lo_j = rng.uniform(0, 0.6, (n_j, l))
        hi_j = lo_j + rng.uniform(0.05, 0.4, (n_j, l))
        norm_j = rng.uniform(0.5, 2.0, n_j)
    ls = rng.uniform(0.2, 1.2, l)
    g_out = rng.normal(size=(n_i, n_j))
    return (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j), g_out


@pytest.mark.parametrize("n_i,n_j,l,gram", [(8, 8, 1, False),
                                            (30, 17, 3, False),
                                            (40, 40, 2, True),
                                            (1, 50, 4, False)])
def test_saved_derivatives_give_the_lengthscale_gradient(n_i, n_j, l, gram):
    arrays, g_out = _se_inputs(n_i * 100 + n_j + l, n_i, n_j, l, gram)
    sigma2 = 1.7
    lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j = (torch.as_tensor(a)
                                                  for a in arrays)
    args = (lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j)
    k_mat, d = pt_ref.se_cov_derivs_ref(*args)
    assert d.shape == (l, n_i, n_j)
    assert torch.equal(k_mat, pt_ref.se_cov_matrix_ref(*args))
    g = torch.as_tensor(g_out)
    got = (g[None] * d).sum((1, 2))
    torch.testing.assert_close(
        got, pt_ref.se_cov_grad_ref(*args, g), rtol=1e-12, atol=0.0)

    def loss(z):
        return jnp.sum(jnp.asarray(g_out) * jx_se_ref(
            *(jnp.asarray(a) for a in arrays[:4]), z, sigma2,
            jnp.asarray(arrays[5]), jnp.asarray(arrays[6])))

    want = np.asarray(jax.grad(loss)(jnp.asarray(arrays[4])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrappers_on_the_cpu_are_their_plain_versions(dtype):
    arrays, g_out = _se_inputs(5, 33, 33, 3, gram=True)
    lo, hi, _, _, ls, norm, _ = (torch.as_tensor(a, dtype=dtype)
                                 for a in arrays)
    before = launch_counts()
    got = pt_se.se_cov_gram(lo, hi, ls, 1.7, norm)
    assert got.dtype == dtype
    assert torch.equal(got, pt_ref.se_cov_matrix_ref(lo, hi, lo, hi, ls, 1.7,
                                                     norm, norm))
    k_mat, d = pt_se.se_cov_derivs(lo, hi, lo, hi, ls, 1.7, norm, norm)
    want_k, want_d = pt_ref.se_cov_derivs_ref(lo, hi, lo, hi, ls, 1.7, norm,
                                              norm)
    assert torch.equal(k_mat, want_k) and torch.equal(d, want_d)
    assert torch.equal(k_mat, got)
    k_gram, d_gram = pt_se.se_cov_gram_derivs(lo, hi, ls, 1.7, norm)
    assert torch.equal(k_gram, want_k) and torch.equal(d_gram, want_d)
    assert launch_counts() == before  # CPU: no launch
