"""Sharded scan plane and its two kernels' plain versions, against the JAX
reference (CPU).

The same numpy inputs, made from a seed, go through the reference and the
port. Tolerances:
  - inside the port, the sharded scan is BITWISE the local scan over the
    matrix {1, 7, 63, 64, 100, 1000} tuples × {1, 2, 4, 8} logical shards
    (a ``Mesh`` listing the CPU n times), shards made only of padding
    included;
  - against the reference's ``eval_partials_sharded`` (a mesh of forced host
    devices, ``conftest.forced_devices``): ``count`` and ``scanned`` exact,
    ``sums`` / ``sumsq`` at rtol 1e-11 (f64 folds in another library's
    summation order);
  - K4 (``masked_partials``) against the reference's
    ``masked_partials_fused`` (interpret mode, f64): count exact, rtol 1e-11;
    inside the port, bitwise the fused scan's plain version on the same
    block;
  - K5 (``range_mask_agg``) against the reference's ``eval_partials_kernel``
    (interpret mode, f32): ``count`` and ``scanned`` exact (both compare in
    f32), ``sums`` / ``sumsq`` within the reference's own budget (rtol 2e-4,
    atol 1e-3).
The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``gpu`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro.aqp import executor as jx_exec  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.kernels.fused_masked_scan import ops as jx_fms  # noqa: E402
from repro.kernels.range_mask_agg import ops as jx_rma  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.aqp.relation import Relation  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import RANGE_EPS, launch_counts  # noqa: E402
from repro_torch.kernels.fused_masked_scan import ops as pt_fms  # noqa: E402
from repro_torch.kernels.fused_masked_scan.ref import (  # noqa: E402
    fused_masked_scan_ref, masked_partials_ref)
from repro_torch.kernels.range_mask_agg import ops as pt_rma  # noqa: E402
from repro_torch.kernels.range_mask_agg.ref import (  # noqa: E402
    range_mask_agg_ref)

TUPLE_COUNTS = (1, 7, 63, 64, 100, 1000)
SHARD_COUNTS = (1, 2, 4, 8)
F64 = torch.float64
SCHEMA_KW = dict(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0), cat_sizes=(4,),
                 n_measures=2)


def _block(t, seed=0, cat_sizes=(4,)):
    rng = np.random.default_rng(seed)
    num = rng.uniform(0, 1, (t, 2))
    cat = (np.stack([rng.integers(0, s, t) for s in cat_sizes], 1)
           if cat_sizes else np.zeros((t, 0))).astype(np.int32)
    measures = rng.normal(1.0, 2.0, (t, 2))
    return num, cat, measures


def _snippet_kw(cat_sizes=(4,)):
    """Five ranges (some with a categorical set) and one that matches ~no
    tuple."""
    ranges = [{0: (a, a + 3.0)} for a in np.linspace(0.0, 6.0, 5)]
    ranges.append({0: (9.99, 9.991), 1: (0.0, 0.001)})
    cats = [{} for _ in ranges]
    for i, k in enumerate(range(len(cat_sizes))):
        cats[i] = {k: (0, cat_sizes[k] - 1)}
    cats[3] = {0: (1, 2)} if cat_sizes else {}
    return dict(agg=[0, 0, 1, 1, 0, 0], measure=[0, 1, 0, 0, 1, 0],
                num_ranges=ranges, cat_sets=cats)


def _both(t, seed, cat_sizes=(4,)):
    """(jax args, port args): (num, cat, measures, padded snippets)."""
    kw = dict(SCHEMA_KW, cat_sizes=cat_sizes)
    num, cat, meas = _block(t, seed, cat_sizes)
    skw = _snippet_kw(cat_sizes)
    jsn = jx_types.pad_snippets(jx_types.make_snippets(
        jx_types.Schema(**kw), **skw))
    psn = pt_types.pad_snippets(pt_types.make_snippets(
        pt_types.Schema(**kw), **skw))
    return ((jnp.asarray(num), jnp.asarray(cat), jnp.asarray(meas), jsn),
            (torch.as_tensor(num), torch.as_tensor(cat),
             torch.as_tensor(meas), psn))


def _cpu_mesh(n):
    return pt_exec.Mesh(("cpu",) * n)


def _assert_bitwise(a, b):
    for f in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _assert_close(got, want, rtol=1e-11, atol=0.0):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.scanned.numpy(),
                                  np.asarray(want.scanned))
    for f in ("sums", "sumsq"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


# --------------------------------------------------------------- the matrix
@pytest.mark.parametrize("n", SHARD_COUNTS)
@pytest.mark.parametrize("t", TUPLE_COUNTS)
def test_sharded_equals_local_bitwise(t, n):
    """Every (tuple count, shard count) cell, including shards made only of
    padding (t < n) and tuple counts the mesh does not divide."""
    _, (num, cat, meas, snips) = _both(t, seed=t)
    local = pt_exec.eval_partials(num, cat, meas, snips)
    # The gathered mask goes through K4's wrapper, whose CPU path (K4's
    # plain version) gives the plain scan's bits.
    sharded = pt_exec.eval_partials_sharded(_cpu_mesh(n), num, cat, meas,
                                            snips)
    _assert_bitwise(sharded, local)
    assert float(sharded.scanned) == float(t)


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("t", (7, 100, 1000))
def test_sharded_matches_reference(t, n, forced_devices):
    jargs, pargs = _both(t, seed=t + 1)
    mesh = JaxMesh(np.array(forced_devices(n)), ("data",))
    want = jx_exec.eval_partials_sharded(mesh, "data", *jargs)
    got = pt_exec.eval_partials_sharded(_cpu_mesh(n), *pargs)
    _assert_close(got, want)


def test_caller_valid_mask_threads_through_sharded(forced_devices):
    """A caller's validity mask composes with the padding mask: the rows it
    zeroes vanish from counts and ``scanned``, as in the reference."""
    jargs, pargs = _both(100, seed=13)
    keep = (np.arange(100) % 3 != 0).astype(np.float64)
    mesh = JaxMesh(np.array(forced_devices(2)), ("data",))
    want = jx_exec.eval_partials_sharded(mesh, "data", *jargs,
                                         valid=jnp.asarray(keep))
    valid = torch.as_tensor(keep)
    got = pt_exec.eval_partials_sharded(_cpu_mesh(2), *pargs, valid=valid)
    _assert_close(got, want)
    assert float(got.scanned) == keep.sum()
    _assert_bitwise(got, pt_exec.eval_partials(*pargs, valid=valid))


def test_padding_and_tile_counts_match_reference():
    for t in TUPLE_COUNTS:
        for n in (1, 2, 3, 4, 6, 8):
            assert (pt_exec.padded_tuple_count(t, n)
                    == jx_exec.padded_tuple_count(t, n))
    jargs, pargs = _both(100, seed=7)
    got = pt_exec.pad_tuple_axis(8, pargs[0], pargs[1], pargs[2])
    want = jx_exec.pad_tuple_axis(8, jargs[0], jargs[1], jargs[2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Padding rows are exactly 0.0 in the masked predicate mask; valid rows
    # are untouched.
    num_p, cat_p, meas_p, valid = got
    masked = pt_exec.predicate_mask(num_p, cat_p, pargs[3], valid)
    assert torch.equal(masked[:100],
                       pt_exec.predicate_mask(*pargs[:2], pargs[3]))
    assert not bool(masked[100:].any()) and not bool(meas_p[100:].any())


def _spy(monkeypatch, module, name):
    """Record each call of ``module.name`` and pass it through."""
    calls, real = [], getattr(module, name)

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _relation(t, seed):
    _, (num, cat, meas, snips) = _both(t, seed=seed)
    return Relation(pt_types.Schema(**SCHEMA_KW), num, cat, meas,
                    num_normalized=num), snips


def test_local_placement_defaults_to_the_fused_scan_wrapper(monkeypatch):
    """With no evaluator given, the local placement goes through K1's
    wrapper (the kernel on the card, its plain version here), which gives
    the plain scan's bits on the CPU and names itself ``oracle`` there."""
    rel, snips = _relation(100, seed=23)
    calls = _spy(monkeypatch, pt_fms, "eval_partials_fused")
    local = pt_exec.ScanPlacement()
    got = local.eval_block(rel, snips)
    assert len(calls) == 1
    _assert_bitwise(got, pt_exec.eval_partials(rel.num_normalized, rel.cat,
                                               rel.measures, snips))
    assert local.stats()["evaluator"] == "oracle"


def test_placements_report_true_counts_and_their_evaluator(monkeypatch):
    rel, snips = _relation(100, seed=19)
    num, cat, meas = rel.num_normalized, rel.cat, rel.measures
    cpu, card = torch.device("cpu"), torch.device("cuda")
    local = pt_exec.scan_placement(None)
    assert local.describe() == "local" and local.n_shards == 1
    assert local.evaluator_for(pt_exec.eval_partials, cpu) == "oracle"
    # K1's wrapper names what it runs: its plain version (the oracle, bit
    # for bit) on the CPU, the kernel on the card.
    assert local.evaluator_for(pt_fms.eval_partials_fused, cpu) == "oracle"
    assert local.evaluator_for(pt_fms.eval_partials_fused, card) == \
        "fused_masked_scan"
    assert local.evaluator_for(pt_rma.eval_partials_kernel, card) == \
        "range_mask_agg"
    _assert_bitwise(local.eval_block(rel, snips),
                    pt_exec.eval_partials(num, cat, meas, snips))
    place = pt_exec.scan_placement(_cpu_mesh(8))
    assert isinstance(place, pt_exec.ShardedScanPlacement)
    assert place.describe() == "sharded:8xdata"
    # Whatever the evaluator, the gathered mask goes through K4's wrapper,
    # which folds plainly on the CPU.
    for fn in (pt_exec.eval_partials, pt_fms.eval_partials_fused):
        assert place.evaluator_for(fn, cpu) == "sharded_mask+oracle_agg"
    calls = _spy(monkeypatch, pt_fms, "masked_partials_fused")
    _assert_bitwise(place.eval_block(rel, snips, pt_fms.eval_partials_fused),
                    pt_exec.eval_partials(num, cat, meas, snips))
    assert len(calls) == 1
    st = place.stats()
    assert (st["kind"], st["n_shards"], st["blocks_evaluated"],
            st["tuples_scanned"], st["pad_rows"], st["evaluator"]) == (
        "sharded", 8, 1, 100, 28, "sharded_mask+oracle_agg")
    num_p, cat_p, _, valid_p = pt_exec.pad_tuple_axis(8, num, cat, None)
    shards = place.place(num_p, cat_p, valid_p)
    assert len(shards) == 8 and all(len(a) == 16 for s in shards for a in s)


def test_mesh_resolves_and_validates_devices():
    mesh = pt_exec.Mesh(("cpu", torch.device("cpu")))
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.shape == {"data": 2}
    with pytest.raises(ValueError, match="at least one device"):
        pt_exec.Mesh(())
    with pytest.raises(ValueError, match="needs axis_sizes"):
        pt_exec.Mesh(("cpu",), ("data", "model"))
    with pytest.raises(ValueError, match="do not cover"):
        pt_exec.Mesh(("cpu",), ("data", "model"), (2, 1))
    assert pt_exec.Mesh(("cpu",), ("data", "model"), (1, 1)).shape == \
        {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt_exec.Mesh(("cuda",))


# ---------------------------------------------------------------------- K4
@pytest.mark.parametrize("t", (100, 1000))
def test_masked_partials_plain_version_matches_reference(t):
    """K4's plain version against the reference's Pallas kernel (interpret
    mode, f64) on the same mask; and on the CPU, bitwise the fused scan's
    plain version on the block the mask came from."""
    jargs, (num, cat, meas, snips) = _both(t, seed=t + 3)
    jmask = jx_exec.predicate_mask(jargs[0], jargs[1], jargs[3])
    want = jx_fms.masked_partials_fused(jmask, jargs[2], jargs[3],
                                        jnp.asarray(float(t)))
    mask = pt_exec.predicate_mask(num, cat, snips)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    before = launch_counts()["masked_partials"]
    got = pt_fms.masked_partials_fused(mask, meas, snips,
                                       torch.tensor(float(t), dtype=F64))
    assert launch_counts()["masked_partials"] == before  # CPU: no launch
    _assert_close(got, want)
    assert torch.equal(
        masked_partials_ref(mask, meas),
        fused_masked_scan_ref(num, cat, None, meas, snips.lo, snips.hi,
                              snips.cat))


def _partition(ranges, n):
    """The distinct ``ranges`` tile [0, n) end to end, none overlapping."""
    ranges = sorted(set((r.start, r.stop) for r in ranges))
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (_, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(a < b for a, b in ranges)
    return ranges


@pytest.mark.parametrize("q_n", (1, 33, 129, 4097))
@pytest.mark.parametrize("t", (1, 255, 257, 60013))
def test_masked_partials_launch_plan(t, q_n):
    """K4's launch plan (the wrapper's, which the card's build reports as
    its own in the gpu tests): every (tuple, snippet) pair lies in exactly
    one block, the chunks are K1's (exactly FMS_CHUNK_T wide, the last one
    ragged), so K4's bits stay K1's, and the scratch and the second pass
    hold every partial."""
    m = 2
    plan = pt_fms.masked_partials_plan(t, q_n, m)
    blocks = [plan.block(b) for b in range(plan.blocks)]
    chunks = _partition([tr for tr, _ in blocks], t)
    tiles = _partition([qr for _, qr in blocks], q_n)
    assert len(blocks) == len(chunks) * len(tiles)
    assert len(set((tr.start, qr.start) for tr, qr in blocks)) == len(blocks)
    assert all(a == c * pt_fms.FMS_CHUNK_T for c, (a, _) in enumerate(chunks))
    assert all(b - a == pt_fms.FMS_CHUNK_T for a, b in chunks[:-1])
    assert plan.n_chunks == len(chunks) == -(-t // pt_fms.FMS_CHUNK_T)
    assert plan.scratch == (plan.n_chunks, q_n, 2 * m + 1)
    assert plan.fold_blocks * pt_fms.MPA_FOLD_WIDTH >= q_n * (2 * m + 1)


# ---------------------------------------------------------------------- K5
@pytest.mark.parametrize("valid", (False, True))
@pytest.mark.parametrize("cats", ((), (4,), (3, 2, 5)))
def test_range_mask_agg_plain_version_matches_reference(cats, valid):
    t = 1237  # not a multiple of the 512-tuple tile
    jargs, pargs = _both(t, seed=len(cats) + 31, cat_sizes=cats)
    keep = (np.arange(t) % 5 != 0).astype(np.float64)
    jv = jnp.asarray(keep) if valid else None
    pv = torch.as_tensor(keep) if valid else None
    want = jx_rma.eval_partials_kernel(*jargs, jv)
    before = launch_counts()["range_mask_agg"]
    got = pt_rma.eval_partials_kernel(*pargs, pv)
    assert launch_counts()["range_mask_agg"] == before  # CPU: no launch
    _assert_close(got, want, rtol=2e-4, atol=1e-3)
    # Against the f64 scan the counts are exact.
    np.testing.assert_array_equal(
        got.count.numpy(), pt_exec.eval_partials(*pargs, pv).count.numpy())


def test_range_mask_agg_compares_in_float32_like_the_reference():
    """lo ± {0, 1e-12, 1e-8, 3e-8, 5e-8, 1e-7}: x and the widened bounds are
    rounded to float32 before the compare, in both packages, so membership
    agrees tuple by tuple — and differs from the float64 scan's for a tuple
    less than a float32 ulp below the bound (0.5 − 1e-8 rounds to 0.5)."""
    offsets = np.asarray([0.0, 1e-12, -1e-12, 1e-7, -1e-7, -5e-8, 3e-8,
                          -3e-8, -1e-8])
    x = np.stack([0.5 + offsets, np.full_like(offsets, 0.5)], 1)
    payload = np.ones((len(offsets), 3))
    lo = np.asarray([[0.5, 0.0]])
    hi = np.asarray([[0.9, 1.0]])
    want = jx_rma.range_mask_agg(*(jnp.asarray(v) for v in (x, payload, lo,
                                                            hi)))
    got = pt_rma.range_mask_agg(*(torch.as_tensor(v) for v in (x, payload,
                                                               lo, hi)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, range_mask_agg_ref(*(torch.as_tensor(v) for v in
                                                 (x, payload, lo, hi))))
    f64_count = float(((x >= lo - RANGE_EPS) & (x <= hi + RANGE_EPS))
                      .all(1).sum())
    assert float(got[0, -1]) == f64_count + 1.0  # the -1e-8 tuple


def test_wrappers_reject_other_devices():
    _, (num, cat, meas, snips) = _both(8, seed=2)
    mask = pt_exec.predicate_mask(num, cat, snips)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_fms.masked_partials(mask.to("meta"), meas.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pt_rma.range_mask_agg(num.to("meta"), meas.to("meta"),
                              snips.lo.to("meta"), snips.hi.to("meta"))


def k5_boundary_study(n_rows=6_001_215, batch=0, seed=0, log=print):
    """Both packages' K5 evaluator (float32 compares) against their own
    float64 scan on one sample batch of the ``tpch_like`` relation, with the
    fused snippets of a 200-query ``tpch_workload`` (``chip_smoke.py``
    phase 5's). Returns ``{package: {snippet: count difference}}``."""
    from repro.aqp import workload as jx_w
    from repro.aqp.plan import plan_workload as jx_plan
    from repro.core.engine import EngineConfig as JxConfig
    from repro.core.engine import VerdictEngine as JxEngine
    from repro_torch.aqp import workload as pt_w
    from repro_torch.aqp.plan import plan_workload as pt_plan
    from repro_torch.core.engine import EngineConfig as PtConfig
    from repro_torch.core.engine import VerdictEngine as PtEngine

    cfg = dict(sample_rate=0.1, n_batches=10, capacity=2000, seed=seed)
    out = {}
    for name, w, cfg_t, eng_t, plan, lib, rma, exec_, kw in (
            ("reference", jx_w, JxConfig, JxEngine, jx_plan, jx_types,
             jx_rma, jx_exec, {}),
            ("port", pt_w, PtConfig, PtEngine, pt_plan, pt_types, pt_rma,
             pt_exec, {"device": "cpu"})):
        rel = w.tpch_like(seed, n_rows=n_rows, **kw)
        eng = eng_t(rel, cfg_t(**cfg), **kw)
        snips = lib.pad_snippets(plan(eng, w.tpch_workload(
            seed + 9, rel.schema, 200)).fused)
        blk = eng.batches.relation.take(eng.batches.batch_rows[batch])
        args = (blk.num_normalized, blk.cat, blk.measures, snips)
        diff = (np.asarray(rma.eval_partials_kernel(*args).count)
                - np.asarray(exec_.eval_partials(*args).count))
        out[name] = {int(q): float(diff[q]) for q in np.nonzero(diff)[0]}
        log(f"{name}: K5 count minus float64 scan count on batch {batch} "
            f"({len(blk.cat)} tuples, {snips.lo.shape[0]} snippets): "
            f"{out[name]}")
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=k5_boundary_study.__doc__
                                 .splitlines()[0])
    ap.add_argument("--rows", type=int, default=6_001_215)
    ap.add_argument("--batch", type=int, default=0)
    a = ap.parse_args()
    res = k5_boundary_study(a.rows, a.batch)
    print("packages agree" if res["reference"] == res["port"]
          else "packages DIFFER")
