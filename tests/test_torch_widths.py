"""Widths past what one launch of a card kernel takes (CPU).

The card's kernels keep per-width state in registers, so a launch of K1
and K4 folds at most 8 measures, a warp of K5 at most 20 payload columns,
and K3 has kernels of its own up to 8 numeric dimensions. The reference's
kernels take any width, so the port launches over groups (K1, K4), cuts
the columns into groups of warps in one launch (K5) or runs its kernels
for any width (K3); the card holds those in ``test_torch_gpu.py``. Here:

  - the pure-Python grouping of ``measure_groups``, and each group's
    columns back in ``[m, m², 1]`` order (``group_columns``), for M in
    {0, 1, 8, 9, 17};
  - K5's wrapper against the reference's Pallas kernel (interpret mode)
    at P up to 130 payload columns (on the card one launch of column
    groups);
  - the port's fused-scan wrapper against the reference's Pallas kernel
    (interpret mode) at the widths that pick each of the card's paths and
    past one launch's 8 measures (``test_torch_scan.py``'s tolerances);
  - K3's Gram plan above its templated widths (no Gram blocks);
  - a relation with 9 numeric dimensions and 9 measures: the port's engine
    answers like the JAX engine (cells at rtol 1e-9, equal ``batches_used``
    and ``accepted``; ``test_torch_engine.py``'s tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.kernels.fused_masked_scan import ops as jx_fms  # noqa: E402
from repro.kernels.range_mask_agg import ops as jx_rma  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels.fused_masked_scan import ops as pt_fms  # noqa: E402
from repro_torch.kernels.range_mask_agg import ops as pt_rma  # noqa: E402
from repro_torch.kernels.se_covariance import ops as pt_se  # noqa: E402
from test_torch_engine import (  # noqa: E402
    _assert_same_answers, _to_reference_query)


@pytest.mark.parametrize("m", [0, 1, 8, 9, 17])
def test_measure_groups_cover_every_column_once(m):
    groups = pt_fms.measure_groups(m)
    assert [first for first, _ in groups] == list(
        range(0, max(m, 1), pt_fms.FMS_GROUP))
    assert all(1 <= count <= pt_fms.FMS_GROUP for _, count in groups) or (
        m == 0 and groups == [(0, 0)])
    assert sum(count for _, count in groups) == m
    written = []
    for first, count in groups:
        cols = pt_fms.group_columns(m, first, count)
        assert len(cols) == 2 * count + 1
        # A group's (Q, 2·count+1) launch is [its m, its m², the count].
        assert cols[:count] == list(range(first, first + count))
        assert cols[count:2 * count] == list(range(m + first,
                                                   m + first + count))
        assert cols[-1] == 2 * m
        written += cols[:-1]
    assert sorted(written) == list(range(2 * m))
    expected = {0: [(0, 0)], 1: [(0, 1)], 8: [(0, 8)], 9: [(0, 8), (8, 1)],
                17: [(0, 8), (8, 8), (16, 1)]}
    assert groups == expected[m]


@pytest.mark.parametrize("p", [1, 17, 18, 35, 64, 130])
def test_payload_groups_cover_every_column_once(p):
    """K5 over P payload columns, which the card folds in one launch of
    column groups (the groups are the C plan's; ``test_torch_gpu.py``
    holds them): the port's wrapper on the CPU against the reference's
    Pallas kernel (interpret mode) gives every column once, in order, the
    count exact and the sums within the reference's float32 budget (rtol
    2e-4, atol 1e-3, ``test_torch_sharded.py``'s)."""
    rng = np.random.default_rng(p)
    t, q_n, l = 300, 7, 3
    x = rng.uniform(0.0, 1.0, (t, l))
    # Column j has mean j + 1, so a column out of place cannot pass.
    payload = np.concatenate([rng.normal(np.arange(1, p), 1.0, (t, p - 1)),
                              np.ones((t, 1))], 1)
    lo = rng.uniform(0.0, 0.5, (q_n, l))
    hi = lo + rng.uniform(0.2, 0.5, (q_n, l))
    extra = (rng.uniform(size=(t, q_n)) < 0.7).astype(np.float32)
    inputs = (x, payload, lo, hi, extra)
    want = np.asarray(jx_rma.range_mask_agg(*map(jnp.asarray, inputs)))
    got = pt_rma.range_mask_agg(*map(torch.as_tensor, inputs))
    assert got.shape == want.shape == (q_n, p)
    np.testing.assert_array_equal(got[:, -1].numpy(), want[:, -1])
    assert float(got[:, -1].min()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("l,cats,m", [
    (3, (3, 2, 25), 2),        # the main path's widths
    (2, (40,), 8),             # 64-bit category words on the card
    (9, (3, 2, 5), 1),         # more numeric dims than the registers take
    (3, (3, 2, 5, 4, 2), 2),   # more categorical dims than they take
    (1, (70,), 3),             # more values than a 64-bit word
    (4, (3,), 12)])            # two measure groups on the card
def test_fused_scan_matches_reference_kernel_at_any_width(l, cats, m):
    """The reference's Pallas kernel (interpret mode) against the port's
    wrapper: count and scanned exact, sums and sums of squares at rtol
    1e-11, every measure read by some snippet."""
    rng = np.random.default_rng(100 * l + m)
    t, q_n = 300, 2 * m + 3
    kw = dict(num_lo=(0.0,) * l, num_hi=(10.0,) * l, cat_sizes=cats,
              n_measures=m)
    num = rng.uniform(0, 1, (t, l))
    cat = np.stack([rng.integers(0, v, t) for v in cats], 1).astype(np.int32)
    meas = rng.normal(1.0, 2.0, (t, m))
    lo = rng.uniform(0.0, 6.0, (q_n, l))
    width = rng.uniform(3.0, 8.0, (q_n, l))
    snip_kw = dict(
        agg=[1] * q_n, measure=[i % m for i in range(q_n)],
        num_ranges=[{d: (lo[i, d], lo[i, d] + width[i, d]) for d in range(l)}
                    for i in range(q_n)],
        cat_sets=[{k: np.flatnonzero(rng.uniform(size=v) < 0.8)
                   for k, v in enumerate(cats)} for _ in range(q_n)])
    jsn = jx_types.pad_snippets(jx_types.make_snippets(
        jx_types.Schema(**kw), **snip_kw))
    psn = pt_types.pad_snippets(pt_types.make_snippets(
        pt_types.Schema(**kw), **snip_kw))
    want = jx_fms.eval_partials_fused(jnp.asarray(num), jnp.asarray(cat),
                                      jnp.asarray(meas), jsn)
    got = pt_fms.eval_partials_fused(torch.as_tensor(num),
                                     torch.as_tensor(cat),
                                     torch.as_tensor(meas), psn)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.scanned.numpy(),
                                  np.asarray(want.scanned))
    assert float(got.count.sum()) > 0
    for f in ("sums", "sumsq"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-11,
                                   atol=0, err_msg=f)


def test_se_cov_plan_above_the_templated_widths():
    """Above ``SE_MAX_L`` a Gram matrix runs the Gram kernel for any width:
    the upper triangle of ``SE_ANY_TILE`` square tiles, a pair a thread."""
    plan = pt_se.se_cov_plan(100, pt_se.SE_MAX_L)
    assert plan.blocks == 4 * 5 // 2 and plan.max_l == pt_se.SE_MAX_L
    for l in (pt_se.SE_MAX_L + 1, 12, 40):
        wide = pt_se.se_cov_plan(100, l)
        assert wide.tile == wide.rows == pt_se.SE_ANY_TILE == 8
        assert wide.n_tiles == 13 and wide.blocks == 13 * 14 // 2


REL_KW = dict(seed=12, n_rows=20_000, n_num=9, cat_sizes=(4,), n_measures=9)
CFG_KW = dict(sample_rate=0.2, n_batches=3, seed=2, capacity=48)


def test_engine_over_nine_dims_and_nine_measures_matches_reference():
    """``make_relation(n_num=9, n_measures=9)``: the same relation in both
    packages, a warm-up through ``execute_many`` and queries one by one to
    a 5% target; cells at rtol 1e-9, equal decisions, the improve path
    exercised."""
    jr = jx_w.make_relation(**REL_KW)
    pr = pt_w.make_relation(**REL_KW, device="cpu")
    np.testing.assert_array_equal(pr.measures.numpy(), np.asarray(jr.measures))
    qs = pt_w.make_workload(4, pr.schema, 24,
                            agg_kinds=("AVG", "COUNT", "SUM"))
    assert {a.measure for q in qs for a in q.aggs} >= {0, 8}
    assert max(p.dim for q in qs for p in q.predicates
               if hasattr(p, "lo")) >= 8
    jeng = jx_engine.VerdictEngine(jr, jx_engine.EngineConfig(**CFG_KW))
    peng = pt_engine.VerdictEngine(pr, pt_engine.EngineConfig(**CFG_KW),
                                   device="cpu")
    jqs = [_to_reference_query(q) for q in qs]
    for got, want in zip(peng.execute_many(qs[:12]),
                         jeng.execute_many(jqs[:12])):
        _assert_same_answers(got, want, 1e-9)
    accepted = 0
    for q, jq in zip(qs[12:], jqs[12:]):
        got = peng.execute(q, target_rel_error=0.05)
        want = jeng.execute(jq, target_rel_error=0.05)
        _assert_same_answers(got, want, 1e-9)
        if want.snippet_answer is not None:
            accepted += int(np.asarray(want.snippet_answer.accepted).sum())
    assert accepted > 0  # the improve path, not only raw answers, was held
