"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
The file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Inputs are made from a seed with numpy. Tolerances:
  - K1 (``fused_masked_scan``) and K4 (``masked_partials``), f64: count
    exact, sums at rtol 1e-11, bitwise across runs; K4 on a block's
    predicate mask is bitwise K1 on that block;
  - K5 (``range_mask_agg``), f32: counts exact, sums at rtol 1e-5, bitwise
    across runs;
  - the scan placements launch the kernel of their route: K1 for a local
    block with no evaluator given, K4 (and no K1) for a block over a mesh;
  - K3 (``se_cov_matrix``), forward: f64 at rtol 1e-12 on ranges wider than
    0.05, f32 at the reference's rtol 2e-5 / atol 1e-7; its gradient kernel
    (``se_cov_grad``) against autograd of the plain version at rtol 1e-9
    (another summation order); both bitwise across runs; a refit on the
    card launches both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.aqp.relation import Relation  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.fused_masked_scan import ops as pt_fms  # noqa: E402
from repro_torch.kernels.fused_masked_scan.ref import (  # noqa: E402
    fused_masked_scan_ref, masked_partials_ref)
from repro_torch.kernels.range_mask_agg import ops as pt_rma  # noqa: E402
from repro_torch.kernels.range_mask_agg.ref import (  # noqa: E402
    range_mask_agg_ref)
from repro_torch.kernels.se_covariance import ops as pt_se  # noqa: E402
from repro_torch.kernels.se_covariance.ref import (  # noqa: E402
    se_cov_grad_ref, se_cov_matrix_ref)

pytestmark = pytest.mark.gpu

CATS = (3, 2, 5)


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with chip_smoke.py or pytest "
                    "-m gpu on the card)")


def _block(t, seed, q_n=None, cat_sizes=CATS):
    """(schema, num, cat, measures, snippets padded to ``q_n``) on the
    card."""
    rng = np.random.default_rng(seed)
    num = rng.uniform(0, 1, (t, 2))
    cat = np.stack([rng.integers(0, s, t) for s in cat_sizes],
                   1).astype(np.int32)
    measures = rng.normal(1.0, 2.0, (t, 2))
    schema = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                             cat_sizes=cat_sizes, n_measures=2)
    ranges = [{0: (a, a + 3.0)} for a in np.linspace(0.0, 6.0, 5)]
    ranges.append({0: (9.99, 9.991), 1: (0.0, 0.001)})  # matches ~nothing
    cats = [{} for _ in ranges]
    for k, size in enumerate(cat_sizes):
        cats[k] = {k: (0, size - 1)}
    snips = pt_types.make_snippets(
        schema, agg=[0, 0, 1, 1, 0, 0], measure=[0, 1, 0, 0, 1, 0],
        num_ranges=ranges, cat_sets=cats)
    snips = (pt_types.pad_snippets(snips) if q_n is None
             else pt_types.pad_snippets(snips, q_n))
    return (schema, *(torch.as_tensor(v).cuda() for v in (num, cat, measures)),
            snips.to("cuda"))


@pytest.mark.parametrize("q_n", [128, 300])
def test_cuda_kernel_matches_plain_version(q_n):
    """K1 against its plain version, bitwise across runs, count exact, sums
    at rtol 1e-11."""
    _, num, cat, meas, snips = _block(5000, seed=q_n, q_n=q_n)
    got = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                   snips.cat)
    again = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                     snips.cat)
    want = fused_masked_scan_ref(num, cat, None, meas, snips.lo, snips.hi,
                                 snips.cat)
    assert torch.equal(got, again)
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)


@pytest.mark.parametrize("q_n", [128, 300])
def test_cuda_masked_partials_matches_plain_version_and_k1(q_n):
    """K4 against its plain version (count exact, rtol 1e-11), bitwise
    across runs, and bitwise K1 on the block its mask came from."""
    _, num, cat, meas, snips = _block(5000, seed=q_n, q_n=q_n)
    mask = pt_exec.predicate_mask(num, cat, snips)
    got = pt_fms.masked_partials(mask, meas)
    again = pt_fms.masked_partials(mask, meas)
    want = masked_partials_ref(mask, meas)
    k1 = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                  snips.cat)
    assert torch.equal(got, again)
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)
    assert torch.equal(got, k1)


def test_cuda_range_mask_agg_matches_plain_version():
    """K5 against its plain version, counts exact, sums at rtol 1e-5 (f32),
    bitwise across runs."""
    _, num, cat, meas, snips = _block(5000, seed=5)
    f32 = torch.float32
    m = meas.to(f32)
    payload = torch.cat([m, m * m, m.new_ones((len(m), 1))], 1)
    extra = pt_rma.categorical_premask(cat, snips.cat)
    inputs = (num.to(f32), payload, snips.lo.to(f32), snips.hi.to(f32),
              extra)
    got = pt_rma.range_mask_agg(*inputs)
    assert torch.equal(got, pt_rma.range_mask_agg(*inputs))
    want = range_mask_agg_ref(*inputs)
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_local_placement_launches_k1_by_default():
    """``ScanPlacement.eval_block`` with no evaluator runs K1 on a block on
    the card, and names it."""
    schema, num, cat, meas, snips = _block(3000, seed=7)
    rel = Relation(schema, num, cat, meas, num_normalized=num)
    place = pt_exec.ScanPlacement()
    before = launch_counts()
    got = place.eval_block(rel, snips)
    after = launch_counts()
    assert after["fused_masked_scan"] == before["fused_masked_scan"] + 1
    assert place.stats()["evaluator"] == "fused_masked_scan"
    want = pt_fms.eval_partials_fused(num, cat, meas, snips)
    for f in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("n", [1, 3, 4])
def test_mesh_placement_launches_k4_and_matches_local(n):
    """Over a mesh listing the card ``n`` times, a block's mask goes through
    K4 once and never through K1, and the partials are bitwise the local
    placement's."""
    schema, num, cat, meas, snips = _block(3001, seed=11 + n)
    rel = Relation(schema, num, cat, meas, num_normalized=num)
    place = pt_exec.ShardedScanPlacement(pt_exec.Mesh(("cuda",) * n))
    before = launch_counts()
    got = place.eval_block(rel, snips, pt_fms.eval_partials_fused)
    after = launch_counts()
    assert after["masked_partials"] == before["masked_partials"] + 1
    assert after["fused_masked_scan"] == before["fused_masked_scan"]
    assert place.stats()["evaluator"] == "sharded_mask+kernel_agg"
    want = pt_exec.ScanPlacement().eval_block(rel, snips)
    for f in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _se_args(n_i, n_j, l, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    lo_i = rng.uniform(0, 0.6, (n_i, l))
    lo_j = rng.uniform(0, 0.6, (n_j, l))
    vals = (lo_i, lo_i + rng.uniform(0.05, 0.4, (n_i, l)),
            lo_j, lo_j + rng.uniform(0.05, 0.4, (n_j, l)),
            rng.uniform(0.2, 1.2, l))
    norms = (rng.uniform(0.5, 2.0, n_i), rng.uniform(0.5, 2.0, n_j))
    t = [torch.as_tensor(v, dtype=dtype, device="cuda") for v in vals]
    return t + [1.7] + [torch.as_tensor(v, dtype=dtype, device="cuda")
                        for v in norms]


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 0.0),
                                             (torch.float32, 2e-5, 1e-7)])
@pytest.mark.parametrize("n_i,n_j,l", [(8, 8, 1), (100, 30, 3), (257, 64, 5),
                                       (1, 300, 4)])
def test_cuda_se_cov_matches_plain_version(n_i, n_j, l, dtype, rtol, atol):
    args = _se_args(n_i, n_j, l, seed=n_i + n_j + l, dtype=dtype)
    before = launch_counts()["se_cov_matrix"]
    got = pt_se.se_cov_matrix(*args)
    again = pt_se.se_cov_matrix(*args)
    want = se_cov_matrix_ref(*args)
    assert launch_counts()["se_cov_matrix"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_i,n_j,l", [(100, 30, 3), (300, 257, 2)])
def test_cuda_se_cov_grad_matches_autograd_of_plain_version(n_i, n_j, l):
    args = _se_args(n_i, n_j, l, seed=7 * n_i + l)
    g_out = torch.as_tensor(np.random.default_rng(l).normal(size=(n_i, n_j)),
                            device="cuda")
    before = launch_counts()["se_cov_grad"]
    got = pt_se.se_cov_grad(*args, g_out)
    again = pt_se.se_cov_grad(*args, g_out)
    z = args[4].clone().requires_grad_(True)
    out = pt_se.se_cov_matrix(*args[:4], z, *args[5:])
    (via,) = torch.autograd.grad(out, z, g_out)
    assert launch_counts()["se_cov_grad"] == before + 3
    assert torch.equal(got, again) and torch.equal(got, via)
    torch.testing.assert_close(got, se_cov_grad_ref(*args, g_out), rtol=1e-9,
                               atol=0.0)


def test_cuda_se_cov_refuses_gradients_it_does_not_compute():
    args = _se_args(4, 5, 2, seed=1)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="lo_i"):
        pt_se.se_cov_matrix(*args)


def test_refit_on_the_card_launches_both_k3_wrappers():
    """``VerdictEngine.refit`` on a small relation on the card runs every
    Adam step's covariance through K3's forward and its gradient."""
    from repro_torch.aqp import workload as pt_w
    from repro_torch.core.engine import EngineConfig, VerdictEngine

    rel = pt_w.make_relation(seed=3, n_rows=6_000, n_num=2, cat_sizes=(4,),
                             n_measures=1, device="cuda")
    eng = VerdictEngine(rel, EngineConfig(sample_rate=0.15, n_batches=4,
                                          capacity=128, seed=0))
    eng.execute_many(pt_w.make_workload(1, rel.schema, 12,
                                        agg_kinds=("AVG", "COUNT")))
    eng.drain()
    fits = sum(syn.n >= 3 for syn in eng.store.values())
    assert fits > 0
    before = launch_counts()
    eng.refit(steps=5)
    after = launch_counts()
    assert after["se_cov_matrix"] - before["se_cov_matrix"] >= 5 * fits
    assert after["se_cov_grad"] - before["se_cov_grad"] >= 5 * fits
    sick = {k: v["quarantine_reason"] for k, v in eng.ingest_stats().items()
            if v["quarantined"]}
    assert not sick, sick


def test_ingest_threads_do_not_race_the_first_cuda_linalg_call():
    """A fresh process whose first CUDA linalg calls come from several
    synopses' ingest threads at once: PyTorch's lazy loader of its CUDA
    linear-algebra library raises in all but one of them unless a synopsis
    made that first call before its thread started. No synopsis may be
    quarantined."""
    import os
    import subprocess
    import sys

    script = """
import numpy as np, torch
from repro_torch.core import types as T
from repro_torch.core.synopsis import Synopsis
sch = T.Schema(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0), cat_sizes=(),
               n_measures=1)
syns = [Synopsis(sch, capacity=64, device="cuda") for _ in range(8)]
rng = np.random.default_rng(0)
lo = rng.uniform(0, 0.5, (16, 2))
b = T.make_snippets(sch, agg=0, measure=0,
                    num_ranges=[{0: (a, a + 0.2), 1: (c, c + 0.3)}
                                for a, c in lo]).to("cuda")
for s in syns:
    s.add(b, rng.normal(size=16), np.full(16, 0.01))
for s in syns:
    s.drain()
sick = [s.quarantine_reason for s in syns if s.quarantined]
assert not sick, sick
print("ok")
"""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
