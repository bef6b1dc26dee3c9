"""Scan plane of the PyTorch port against the JAX reference (CPU).

The same numpy inputs, made from a seed, go through the reference's
``eval_partials`` / ``eval_partials_fused`` (interpret mode) and the port's
``eval_partials`` / ``eval_partials_fused`` (whose CPU path is the kernel's
plain version). Tolerances:
  - ``count`` and ``scanned`` exact (sums of exact 0/1 values);
  - ``sums`` / ``sumsq`` at rtol 1e-11 (f64 folds in another library's
    summation order);
  - inside the port, bitwise under Q-padding and tuple-block padding.
The CUDA kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``gpu`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.aqp import executor as jx_exec  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.kernels.fused_masked_scan import ops as jx_fms  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import RANGE_EPS, launch_counts  # noqa: E402
from repro_torch.kernels.fused_masked_scan import ops as pt_fms  # noqa: E402
from repro_torch.kernels.fused_masked_scan.ref import (  # noqa: E402
    fused_masked_scan_ref)

TUPLE_COUNTS = (1, 7, 63, 64, 100, 1000)
CAT_LAYOUTS = {"cat_free": (), "one_cat": (4,), "three_cats": (3, 2, 5)}


def _schema(cat_sizes):
    kw = dict(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0), cat_sizes=cat_sizes,
              n_measures=2)
    return jx_types.Schema(**kw), pt_types.Schema(**kw)


def _block(t, cat_sizes, seed):
    rng = np.random.default_rng(seed)
    num = rng.uniform(0, 1, (t, 2))
    cat = (np.stack([rng.integers(0, s, t) for s in cat_sizes], 1)
           if cat_sizes else np.zeros((t, 0))).astype(np.int32)
    measures = rng.normal(1.0, 2.0, (t, 2))
    return num, cat, measures


def _snippet_kw(cat_sizes):
    ranges = [{0: (a, a + 3.0)} for a in np.linspace(0.0, 6.0, 5)]
    ranges.append({0: (9.99, 9.991), 1: (0.0, 0.001)})  # matches ~nothing
    cats = [{} for _ in ranges]
    for i, k in enumerate(range(len(cat_sizes))):
        cats[i] = {k: (0, cat_sizes[k] - 1)}
    return dict(agg=[0, 0, 1, 1, 0, 0], measure=[0, 1, 0, 0, 1, 0],
                num_ranges=ranges, cat_sets=cats)


def _both(t, cats, seed):
    jsch, psch = _schema(cats)
    num, cat, meas = _block(t, cats, seed)
    kw = _snippet_kw(cats)
    jsn = jx_types.pad_snippets(jx_types.make_snippets(jsch, **kw))
    psn = pt_types.pad_snippets(pt_types.make_snippets(psch, **kw))
    jargs = (jnp.asarray(num), jnp.asarray(cat), jnp.asarray(meas), jsn)
    pargs = (torch.as_tensor(num), torch.as_tensor(cat),
             torch.as_tensor(meas), psn)
    return jargs, pargs


def _assert_close(got, want, exact_only=False):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.scanned.numpy(),
                                  np.asarray(want.scanned))
    if exact_only:
        return
    for f in ("sums", "sumsq"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-11,
                                   atol=0, err_msg=f)


def _assert_bitwise(a, b):
    for f in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("cats", list(CAT_LAYOUTS))
@pytest.mark.parametrize("t", TUPLE_COUNTS)
def test_scan_matches_reference(t, cats):
    jargs, pargs = _both(t, CAT_LAYOUTS[cats], seed=t)
    want = jx_exec.eval_partials(*jargs)
    got = pt_exec.eval_partials(*pargs)
    fused = pt_fms.eval_partials_fused(*pargs)
    _assert_close(got, want)
    _assert_bitwise(fused, got)  # CPU wrapper = the plain version, same bits
    assert float(got.scanned) == float(t)


@pytest.mark.parametrize("cats", list(CAT_LAYOUTS))
def test_scan_matches_reference_fused_kernel(cats):
    """The reference's Pallas kernel (interpret mode) against the port."""
    jargs, pargs = _both(100, CAT_LAYOUTS[cats], seed=11)
    want = jx_fms.eval_partials_fused(*jargs)
    _assert_close(pt_fms.eval_partials_fused(*pargs), want)


@pytest.mark.parametrize("delta,inside", [
    (0.0, True), (1e-12, True), (-1e-12, True), (1e-7, True),
    (-1e-7, False), (-5e-8, False)])
def test_boundary_epsilon_matches_reference(delta, inside):
    """lo ± {0, 1e-12, 1e-7}: the shared RANGE_EPS decides membership in
    both packages, and the count is exact."""
    assert RANGE_EPS == 1e-12
    jsch, psch = _schema((4,))
    kw = dict(agg=[0], measure=[0], num_ranges=[{0: (5.0, 9.0)}])
    num = np.asarray([[0.5 + delta, 0.5]])
    cat = np.zeros((1, 1), np.int32)
    meas = np.ones((1, 2))
    want = jx_exec.eval_partials(
        jnp.asarray(num), jnp.asarray(cat), jnp.asarray(meas),
        jx_types.pad_snippets(jx_types.make_snippets(jsch, **kw)))
    got = pt_fms.eval_partials_fused(
        torch.as_tensor(num), torch.as_tensor(cat), torch.as_tensor(meas),
        pt_types.pad_snippets(pt_types.make_snippets(psch, **kw)))
    assert float(got.count[0]) == float(inside)
    _assert_close(got, want)


def test_scan_bitwise_under_q_padding_and_block_padding():
    """Inside the port: a snippet's partials do not change with how many
    snippets ride along, nor when the tuple block is zero-padded with a
    validity mask."""
    _, (num, cat, meas, snips) = _both(1000, (3, 2, 5), seed=5)
    base = pt_exec.eval_partials(num, cat, meas, snips)
    wide = pt_types.pad_snippets(snips, 384)
    got = pt_fms.eval_partials_fused(num, cat, meas, wide)
    _assert_bitwise(pt_exec.Partials(*(v[:snips.n] for v in (
        got.sums, got.sumsq, got.count)), got.scanned), base)
    num_p, cat_p, meas_p = (torch.cat([v, v.new_zeros((24, v.shape[1]))])
                            for v in (num, cat, meas))
    valid = torch.cat([torch.ones(1000, dtype=torch.float64),
                       torch.zeros(24, dtype=torch.float64)])
    padded = pt_fms.eval_partials_fused(num_p, cat_p, meas_p, snips, valid)
    _assert_bitwise(padded, base)


def test_zero_valid_block_contributes_nothing():
    _, (num, cat, meas, snips) = _both(100, (4,), seed=3)
    got = pt_fms.eval_partials_fused(num, cat, meas, snips,
                                     torch.zeros(100, dtype=torch.float64))
    assert float(got.scanned) == 0.0
    for f in ("sums", "sumsq", "count"):
        assert not bool(getattr(got, f).any())


def test_predicate_mask_matches_reference():
    """Group discovery's plain mask equals the reference's, exactly."""
    jargs, pargs = _both(300, (3, 2, 5), seed=9)
    want = np.asarray(jx_exec.predicate_mask(jargs[0], jargs[1], jargs[3]))
    got = pt_exec.predicate_mask(pargs[0], pargs[1], pargs[3]).numpy()
    np.testing.assert_array_equal(got, want)


def test_estimates_match_reference():
    jargs, pargs = _both(1000, (4,), seed=13)
    jt, jb, jv = jx_exec.estimates_from_partials(
        jx_exec.eval_partials(*jargs), jargs[3])
    pt, pb, pv = pt_exec.estimates_from_partials(
        pt_exec.eval_partials(*pargs), pargs[3])
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-11)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-9)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    _, (num, cat, meas, snips) = _both(64, (4,), seed=1)
    before = launch_counts()["fused_masked_scan"]
    out = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                   snips.cat)
    want = fused_masked_scan_ref(num, cat, None, meas, snips.lo, snips.hi,
                                 snips.cat)
    assert torch.equal(out, want)
    assert launch_counts()["fused_masked_scan"] == before


def test_wrapper_rejects_other_devices():
    _, (num, cat, meas, snips) = _both(8, (4,), seed=2)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_fms.fused_masked_scan(num.to("meta"), cat.to("meta"),
                                 meas.to("meta"), snips.lo.to("meta"),
                                 snips.hi.to("meta"), snips.cat.to("meta"))


def test_launch_counts_add_up_under_threads():
    """``count_launch`` loses no increment when threads count at once
    (the serving thread, the ingest threads and an isolated tenant's
    flushes launch the same kernels): 8 threads x 20,000 launches of a
    wrapper pair and a shape counter, with a short switch interval."""
    import collections
    import sys
    import threading
    import types

    from repro_torch.kernels import count_launch

    a, b = types.SimpleNamespace(launches=0), types.SimpleNamespace(launches=0)
    shapes = collections.Counter()
    n_threads, n = 8, 20_000
    start = threading.Barrier(n_threads)

    def launcher(k):
        start.wait()
        for _ in range(n):
            count_launch(a, *((b,) if k % 2 else ()), shapes=shapes,
                         key=("gram", k % 2))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launcher, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert a.launches == n_threads * n
    assert b.launches == n_threads // 2 * n
    assert shapes == {("gram", 0): n_threads // 2 * n,
                      ("gram", 1): n_threads // 2 * n}
