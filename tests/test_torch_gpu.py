"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
The file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Inputs are made from a seed with numpy. Tolerances:
  - K1 (``fused_masked_scan``) and K4 (``masked_partials``), f64: count
    exact, sums at rtol 1e-11, bitwise across runs; K4 on a block's
    predicate mask is bitwise K1 on that block, at T in {1, 255, 257,
    60013} x Q in {1, 33, 129, 4097} too, and from a mask that is not
    16-byte aligned;
  - K2 (``gp_batch_infer``): f64 at rtol 1e-10 of the plain version, f32
    at rtol 5e-3 / atol 5e-5 of the f64 plain version (the reference's own
    f32 budget), bitwise across runs, the exact-raw branch exact, padded
    inputs (Σ⁻¹ = I, k = 0, α = 0) at the same tolerances as the unpadded
    ones, at Q in {1, 8, 9, 128} x C in {1, 31, 33, 257, 2000};
  - the built kernels' launch plans equal the wrappers' (``mpa_plan``,
    ``gp_plan``);
  - K5 (``range_mask_agg``), f32: counts exact, sums at rtol 1e-5, bitwise
    across runs;
  - the scan placements launch the kernel of their route: K1 for a local
    block with no evaluator given, K4 (and no K1) for a block over a mesh;
  - K3 (``se_cov_matrix``), forward: f64 at rtol 1e-12 on ranges wider than
    0.05, f32 at the reference's rtol 2e-5 / atol 1e-7; its gradient (the
    forward's saved derivatives reduced against the incoming gradient,
    ``se_cov_grad``) against autograd of the plain version at rtol 1e-9
    (another summation order); both bitwise across runs; the Gram kernel
    (``se_cov_gram``) bitwise the general kernel on the same ranges, its
    gradient bitwise the general one's; the saved derivatives within rtol
    1e-12 of the plain ``se_cov_derivs_ref``; the kernels' antiderivative
    bitwise even; the Gram plan of the built library equal to the
    wrapper's; a refit on the card runs the Gram forward with derivatives
    and the reduction on every step, and no forward writes derivatives
    when ``ls`` needs no gradient;
  - workload intelligence on the card: a cache hit moves no launch
    counter and gives the recorded answer bitwise; misses are bitwise a
    cache-free session fed the same misses; the router takes the same
    routes, with bitwise the same answers (each an always-improve twin's),
    under asynchronous and synchronous ingest; the highest fill floor the
    router's ladder learns leaves improved answers bitwise;
  - K2 given a fill padded past its own bucket (to C = 2000, as a fill
    floor of 2048 pads it): bitwise the fill at its bucket, at the
    default floor and through a router whose ladder reaches 2048;
  - the microbatching service on the card: each flush bitwise a twin's
    ``execute_many`` of the same slice, K1 once per scan round; over a
    four-shard mesh bitwise the local service, through K4 alone;
  - launch counts add up when two threads launch K1 at once;
  - the serving front on the card: its miss path bitwise a direct
    session, a shared tenant's hit launching nothing, and over HTTP the
    execute answer and the NDJSON stream's final line bitwise a twin's;
  - the LM serving path, every smoke arch on the card (float32): decode
    equals prefill (last logits at rtol 2e-3 / atol 2e-3, the next token
    the teacher-forced argmax); the card against the CPU on the same
    weights with TF32 off (``forward`` logits at rtol 1e-5 / atol 1e-4,
    the CPU tests' tolerance against the reference; 4 greedy tokens
    equal); two runs of ``generate`` give the same tokens;
  - the LM training path on the card (float32, TF32 off): one AdamW train
    step on a smoke config against the same step on the CPU (the loss at
    rtol 1e-5, ``grad_norm`` at rtol 1e-4, every parameter within 2 lr,
    the bound of two first AdamW updates, and at most 1% of the elements
    beyond atol 1e-6 / rtol 1e-5: an element whose gradient lies within a
    few eps of 0 takes an update that moves with the gradient's last
    bits); recomputation on against off and accum 2 on [x, x] against
    accum 1 on x, within float32 rounding (1e-6); the trainer's
    crash-and-resume gives the uninterrupted run's final loss bitwise; a
    bf16 tree with its AdamW state round-trips a checkpoint bit for bit;
  - the static checker's trace layer on the card: no gating finding over
    the nine programs (K1, K4 and K2 launched under it); the fused scan
    creates no (T, Q) tensor and its peak memory stays below T * Q * 8
    bytes, where the plain scan under the ``fused`` tag is flagged; the
    improve ladder gives one K2 launch signature (with the built library's
    ``gp_plan``) per bucket pair; the mask build over 4 and 8 shards of the
    card has no cross-shard op;
  - group discovery (``group_discovery``) at the benchmark cell's shape
    (599,861 tuples; returnflag, nation and all three columns), on both
    routes: presence and keys equal to the plain version's, bitwise
    across runs, the same groups as on the CPU; a
    group-by ``execute_many`` launches it once, and discovery copies the
    presence table alone to the host;
  - the launch layer on the card: qwen2.5-3b decode_32k's layer probe at
    its cell's shapes and rwkv6-3b's chunk probes, the FLOPs
    ``FlopCounterMode`` counts on the card equal to those on meta; the
    collective recorder's bytes for an MoE over a (2, 2) mesh of the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.aqp.relation import Relation  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.fused_masked_scan import ops as pt_fms  # noqa: E402
from repro_torch.kernels.fused_masked_scan.ref import (  # noqa: E402
    fused_masked_scan_ref, masked_partials_ref)
from repro_torch.kernels.gp_batch_infer import ops as pt_gp  # noqa: E402
from repro_torch.kernels.gp_batch_infer.ref import (  # noqa: E402
    gp_batch_infer_ref)
from repro_torch.kernels.range_mask_agg import ops as pt_rma  # noqa: E402
from repro_torch.kernels.range_mask_agg.ref import (  # noqa: E402
    range_mask_agg_ref)
from repro_torch.kernels.se_covariance import ops as pt_se  # noqa: E402
from repro_torch.kernels.se_covariance.ref import (  # noqa: E402
    se_cov_derivs_ref, se_cov_grad_ref, se_cov_matrix_ref)
from repro_torch.models import params as pt_lm_params  # noqa: E402
from repro_torch.models import transformer as pt_lm  # noqa: E402
from repro_torch.serving import engine as pt_lm_engine  # noqa: E402

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


def _random_snippets(schema, q_n, rng):
    """``q_n`` distinct range snippets over both numeric dims, on the
    card."""
    lo = rng.uniform(0.0, 7.0, (q_n, 2))
    width = rng.uniform(0.5, 5.0, (q_n, 2))
    ranges = [{0: (a, a + w), 1: (b, b + x)}
              for (a, b), (w, x) in zip(lo, width)]
    cats = [{0: (0, 1)} if i % 3 == 0 else {} for i in range(q_n)]
    return pt_types.make_snippets(
        schema, agg=[i % 2 for i in range(q_n)],
        measure=[i % 2 for i in range(q_n)], num_ranges=ranges,
        cat_sets=cats).to("cuda")


@pytest.mark.parametrize("q_n", [1, 33, 129, 4097])
@pytest.mark.parametrize("t", [1, 255, 257, 60013])
def test_cuda_masked_partials_edge_shapes_are_k1_bitwise(t, q_n):
    """K4 at the ragged shapes (partial chunks, partial snippet tiles, odd
    Q and so 8-byte copies): bitwise K1 on the same block, bitwise on a
    repeat, count exact and sums at rtol 1e-11 of the plain version."""
    schema, num, cat, meas, _ = _block(t, seed=t + q_n)
    snips = _random_snippets(schema, q_n, np.random.default_rng(q_n))
    mask = pt_exec.predicate_mask(num, cat, snips)
    before = launch_counts()["masked_partials"]
    got = pt_fms.masked_partials(mask, meas)
    again = pt_fms.masked_partials(mask, meas)
    assert launch_counts()["masked_partials"] == before + 2
    k1 = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                  snips.cat)
    want = masked_partials_ref(mask, meas)
    assert torch.equal(got, again)
    assert torch.equal(got, k1)
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)


def test_cuda_masked_partials_from_an_unaligned_mask():
    """A contiguous mask whose first element is 8 (not 16) bytes aligned
    takes the 8-byte copies and gives the same bits."""
    schema, num, cat, meas, _ = _block(3000, seed=3)
    snips = _random_snippets(schema, 64, np.random.default_rng(3))
    mask = pt_exec.predicate_mask(num, cat, snips)
    flat = torch.cat([mask.new_zeros(1), mask.reshape(-1)])
    shifted = flat[1:].view(mask.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    assert torch.equal(pt_fms.masked_partials(shifted, meas),
                       pt_fms.masked_partials(mask, meas))


@pytest.mark.parametrize("t,q_n", [(1, 1), (257, 33), (60013, 128),
                                   (60013, 4097)])
def test_k4_library_plan_equals_the_wrappers(t, q_n):
    plan = pt_fms.masked_partials_plan(t, q_n, 2)
    assert pt_fms.masked_partials_plan_of_library(t, q_n, 2) == (
        plan.n_chunks, pt_fms.MPA_TILE_Q, plan.n_q_tiles, plan.blocks,
        plan.fold_blocks)


def _gp_args(q, c, seed, pad_q=0, pad_c=0):
    """K2's inputs on the card (f64), padded as the engine pads: extra past
    rows with Σ⁻¹ = I, k = 0 and α = 0, extra new rows with raw β² = 1."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, c))
    sinv = a @ a.T / c + np.eye(c)
    k = rng.normal(0, 0.1, (q, c))
    alpha = rng.normal(0, 1, (c,))
    kappa2 = np.einsum("qc,cd,qd->q", k, sinv, k) + rng.uniform(0.05, 0.5, q)
    mu, rawt = rng.normal(0, 1, (q,)), rng.normal(0, 1, (q,))
    rawb = rng.uniform(0.0, 0.3, (q,))
    rawb[0] = 0.0  # the exact-raw branch
    if pad_c:
        sinv = np.block([[sinv, np.zeros((c, pad_c))],
                         [np.zeros((pad_c, c)), np.eye(pad_c)]])
        k = np.concatenate([k, np.zeros((q, pad_c))], 1)
        alpha = np.concatenate([alpha, np.zeros(pad_c)])
    if pad_q:
        k = np.concatenate([k, rng.normal(0, 0.1, (pad_q, k.shape[1]))])
        kappa2, mu, rawt = (np.concatenate([v, np.ones(pad_q)])
                            for v in (kappa2, mu, rawt))
        rawb = np.concatenate([rawb, np.ones(pad_q)])
    return [torch.as_tensor(v, dtype=torch.float64, device="cuda")
            for v in (k, sinv, alpha, kappa2, mu, rawt, rawb)]


def _check_gp(got, want, dtype, q, rawt0):
    rtol, atol = ((1e-10, 0.0) if dtype == torch.float64 else (5e-3, 5e-5))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g[:q].double(), w[:q], rtol=rtol,
                                   atol=atol)
    assert float(got[0][0]) == float(torch.tensor(rawt0, dtype=dtype))
    assert float(got[1][0]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [1, 31, 33, 257, 2000])
@pytest.mark.parametrize("q", [1, 8, 9, 128])
def test_cuda_gp_batch_infer_matches_plain_version(q, c, dtype):
    """K2 against the f64 plain version, bitwise on a repeat, the exact-raw
    branch exact."""
    args = _gp_args(q, c, seed=q * 7 + c)
    want = gp_batch_infer_ref(*args)
    before = launch_counts()["gp_batch_infer"]
    got = pt_gp.gp_batch_infer(*args, dtype=dtype)
    again = pt_gp.gp_batch_infer(*args, dtype=dtype)
    assert launch_counts()["gp_batch_infer"] == before + 2
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    _check_gp(got, want, dtype, q, float(args[5][0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q,c,pad_q,pad_c", [(8, 257, 0, 255),
                                             (9, 33, 7, 31),
                                             (128, 2000, 0, 48)])
def test_cuda_gp_batch_infer_padded_gives_the_unpadded_result(q, c, pad_q,
                                                              pad_c, dtype):
    """Padding as the engine pads (Σ⁻¹ = I, k = 0, α = 0 past rows; extra
    new rows) leaves the real rows' answers within the tolerance."""
    args = _gp_args(q, c, seed=c)
    padded = _gp_args(q, c, seed=c, pad_q=pad_q, pad_c=pad_c)
    want = gp_batch_infer_ref(*args)
    got = pt_gp.gp_batch_infer(*padded, dtype=dtype)
    _check_gp(got, want, dtype, q, float(args[5][0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [257, 2000])
def test_cuda_gp_batch_infer_rows_do_not_depend_on_q(c, dtype):
    """A row's answer is bitwise the same whichever Q bucket (and so which
    tiling) it rides in: the depth split is C's alone."""
    args = _gp_args(128, c, seed=c + 1)
    full = pt_gp.gp_batch_infer(*args, dtype=dtype)
    for q in (8, 40):
        part = [args[0][:q].contiguous(), args[1], args[2]] + [
            a[:q].contiguous() for a in args[3:]]
        for g, h in zip(pt_gp.gp_batch_infer(*part, dtype=dtype), full):
            assert torch.equal(g, h[:q]), q


@pytest.mark.parametrize("q,c", [(1, 1), (9, 33), (128, 2000), (300, 257)])
def test_k2_library_plan_equals_the_wrappers(q, c):
    plan = pt_gp.gp_plan(q, c)
    lib = pt_gp.gp_plan_of_library(q, c)
    assert lib[:6] == (plan.tile_q, plan.tile_c, plan.split,
                       plan.n_row_tiles, plan.n_col_tiles, plan.n_splits)
    assert lib[6] <= 227 * 1024  # fits one block's shared memory


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,l", [(1, 3), (31, 1), (32, 3), (33, 5),
                                 (100, 3), (257, 2), (70, 8), (40, 0)])
def test_cuda_se_cov_gram_is_the_general_kernel_bitwise(n, l, dtype):
    args = _se_args(n, n, l, seed=3 * n + l, dtype=dtype)
    lo, hi, ls, norm = args[0], args[1], args[4], args[6]
    before = launch_counts()
    got = pt_se.se_cov_gram(lo, hi, ls, 1.7, norm)
    again = pt_se.se_cov_gram(lo, hi, ls, 1.7, norm)
    want = pt_se.se_cov_matrix(lo, hi, lo, hi, ls, 1.7, norm, norm)
    after = launch_counts()
    assert after["se_cov_gram"] == before["se_cov_gram"] + 2
    assert after["se_cov_matrix"] == before["se_cov_matrix"] + 1
    assert after["se_cov_derivs"] == before["se_cov_derivs"]
    assert got.dtype == dtype and torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,l", [(1, 3), (31, 3), (32, 3), (33, 3),
                                 (2000, 3), (70, 8), (70, 9), (33, 12)])
def test_k3_library_plan_equals_the_wrappers(n, l):
    plan = pt_se.se_cov_plan(n, l)
    head, tiles = pt_se.se_cov_plan_of_library(n, l)
    assert head == (plan.tile, plan.rows, plan.n_tiles, plan.blocks,
                    plan.reduce_chunk, plan.max_l)
    assert tiles == [plan.tiles(b) for b in range(plan.blocks)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_antiderivative_is_bitwise_even(dtype):
    """The premise of the Gram kernel: F(-u) == F(u) and dF(-u) == dF(u)
    bit for bit in the kernels' own code, and erf odd, over 0, subnormals,
    erf's branch points and |u/z| > 6."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    info = np.finfo(np_dt)
    r = np.concatenate([
        [0.0, info.smallest_subnormal, info.tiny, 0.84375, 1.0, 1.25,
         2.857142857142857, 5.9, 6.0, 6.5, 27.0, 1e10],
        np.logspace(np.log10(float(info.tiny)), 2, 4000),
        np.linspace(0.0, 7.0, 70001)]).astype(np_dt)
    r = np.concatenate([r, np.nextafter(r, np.inf).astype(np_dt),
                        np.nextafter(r, -np.inf).astype(np_dt)])
    for z in (0.3, 0.77, 1.5):
        u = torch.as_tensor(np.abs(r) * np_dt(z), device="cuda")
        f, df = pt_se.se_cov_probe(u, z, with_derivative=True)
        fm, dfm = pt_se.se_cov_probe(-u, z, with_derivative=True)
        assert torch.equal(f, fm) and torch.equal(df, dfm)
        assert torch.equal(pt_se.se_cov_probe(u, z), f)
        rr = u / torch.tensor(z, dtype=dtype, device="cuda")
        assert torch.equal(torch.special.erf(-rr), -torch.special.erf(rr))


@pytest.mark.parametrize("n_i,n_j,l", [(100, 30, 3), (33, 300, 2),
                                       (64, 64, 5)])
def test_cuda_se_cov_derivs_match_plain_version(n_i, n_j, l):
    args = _se_args(n_i, n_j, l, seed=11 * n_i + l)
    before = launch_counts()
    k_mat, d = pt_se.se_cov_derivs(*args)
    after = launch_counts()
    assert after["se_cov_derivs"] == before["se_cov_derivs"] + 1
    assert after["se_cov_matrix"] == before["se_cov_matrix"] + 1
    assert torch.equal(k_mat, pt_se.se_cov_matrix(*args))
    want_k, want_d = se_cov_derivs_ref(*args)
    torch.testing.assert_close(k_mat, want_k, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(d, want_d, rtol=1e-12, atol=1e-300)
    assert torch.equal(pt_se.se_cov_derivs(*args)[1], d)


@pytest.mark.parametrize("n,l", [(1, 3), (33, 2), (300, 3), (97, 8)])
def test_cuda_se_gram_gradient_is_the_general_gradient_bitwise(n, l):
    args = _se_args(n, n, l, seed=5 * n + l)
    lo, hi, ls, norm = args[0], args[1], args[4], args[6]
    g_out = torch.as_tensor(np.random.default_rng(n).normal(size=(n, n)),
                            device="cuda")
    z = ls.clone().requires_grad_(True)
    before = launch_counts()
    k_mat = pt_se.se_cov_gram(lo, hi, z, 1.7, norm)
    (via,) = torch.autograd.grad(k_mat, z, g_out)
    after = launch_counts()
    assert after["se_cov_gram"] == before["se_cov_gram"] + 1
    assert after["se_cov_derivs"] == before["se_cov_derivs"] + 1
    assert after["se_cov_grad"] == before["se_cov_grad"] + 1
    # Writing the derivatives leaves the forward's bits alone.
    assert torch.equal(k_mat.detach(), pt_se.se_cov_gram(lo, hi, ls, 1.7,
                                                         norm))
    general = pt_se.se_cov_grad(lo, hi, lo, hi, ls, 1.7, norm, norm, g_out)
    assert torch.equal(via, general)
    torch.testing.assert_close(
        via, se_cov_grad_ref(lo, hi, lo, hi, ls, 1.7, norm, norm, g_out),
        rtol=1e-9, atol=0.0)
    # No derivatives without a gradient to take.
    before = launch_counts()
    with torch.no_grad():
        pt_se.se_cov_gram(lo, hi, z, 1.7, norm)
    pt_se.se_cov_matrix(lo, hi, lo, hi, ls, 1.7, norm, norm)
    assert launch_counts()["se_cov_derivs"] == before["se_cov_derivs"]


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
    # Every step's NLL builds a Gram matrix with derivatives, and its
    # backward reduces them.
    assert after["se_cov_gram"] - before["se_cov_gram"] >= 5 * fits
    assert after["se_cov_derivs"] - before["se_cov_derivs"] >= 5 * fits
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


# ------------------------------------------------------------ any width
def _measures(t, m, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(1.0, 2.0, (t, m))).cuda()


@pytest.mark.parametrize("m", [9, 12, 17])
def test_cuda_k1_and_k4_take_any_measure_count(m):
    """K1 and K4 over more measures than one launch folds: against their
    plain versions (count exact, rtol 1e-11), bitwise on a repeat, K4
    bitwise K1, one launch a group of ``measure_groups``, and every measure
    column (and the count) bitwise what the kernels give on that measure
    alone."""
    schema, num, cat, _, _ = _block(60013, seed=m)
    snips = _random_snippets(schema, 128, np.random.default_rng(m))
    meas = _measures(60013, m, seed=m + 1)
    args = (num, cat, meas, snips.lo, snips.hi, snips.cat)
    before = launch_counts()
    got = pt_fms.fused_masked_scan(*args)
    assert (launch_counts()["fused_masked_scan"]
            == before["fused_masked_scan"] + len(pt_fms.measure_groups(m)))
    want = fused_masked_scan_ref(num, cat, None, meas, snips.lo, snips.hi,
                                 snips.cat)
    assert torch.equal(got, pt_fms.fused_masked_scan(*args))
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)
    mask = pt_exec.predicate_mask(num, cat, snips)
    k4 = pt_fms.masked_partials(mask, meas)
    assert torch.equal(k4, got)
    for j in range(m):
        one = meas[:, j:j + 1].contiguous()
        alone = pt_fms.fused_masked_scan(num, cat, one, snips.lo, snips.hi,
                                         snips.cat)
        assert torch.equal(got[:, [j, m + j, 2 * m]], alone), j
        assert torch.equal(pt_fms.masked_partials(mask, one), alone), j


@pytest.mark.parametrize("l,cats,path", [(2, (3, 2, 5), 1), (3, (40, 2), 2),
                                         (6, (3,), 0), (2, (3, 2, 2, 2, 2), 0),
                                         (1, (70,), 0), (4, (), 1),
                                         (0, (4,), 1), (2, (30_000, 3), 3),
                                         (2, (3, 100_000), 3)])
def test_cuda_k1_every_path_matches_plain_version_and_k4(l, cats, path):
    """Each of K1's paths (bounds and 32- or 64-bit category words in
    registers, the kernel for any width, or its category words streamed
    through shared memory, past one block's shared memory at 100,000
    values) against the plain version, K4 bitwise K1, and the path the
    built library takes for the shape."""
    t, q_n = 3001, 200
    rng = np.random.default_rng(l * 10 + len(cats))
    num = torch.as_tensor(rng.uniform(0, 1, (t, l))).cuda()
    cat = torch.as_tensor(np.array([rng.integers(0, s, t) for s in cats],
                                   np.int32).reshape(len(cats), t).T
                          .copy()).cuda()
    meas = _measures(t, 2, seed=l)
    v = max(cats, default=1)
    lo = rng.uniform(0, 0.7, (q_n, l))
    hi = lo + rng.uniform(0.1, 0.6, (q_n, l))
    member = rng.uniform(size=(q_n, len(cats), v)) < 0.6
    args = [torch.as_tensor(a).cuda() for a in (lo, hi, member)]
    got = pt_fms.fused_masked_scan(num, cat, meas, *args)
    want = fused_masked_scan_ref(num, cat, None, meas, *args)
    assert torch.equal(got[:, -1], want[:, -1])
    assert float(got[:, -1].sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)
    mask = pt_exec.snippet_mask(num, cat, *args)
    assert torch.equal(pt_fms.masked_partials(mask, meas), got)
    assert pt_fms.fused_scan_plan(t, q_n, 2, l, len(cats), v).path == path


def test_cuda_k1_rows_do_not_depend_on_q():
    """Rows 0..127 of a Q = 4096 launch are bitwise the Q = 128 launch."""
    schema, num, cat, meas, _ = _block(60013, seed=41)
    snips = _random_snippets(schema, 4096, np.random.default_rng(41))
    wide = pt_fms.fused_masked_scan(num, cat, meas, snips.lo, snips.hi,
                                    snips.cat)
    head = snips[np.arange(128)]
    narrow = pt_fms.fused_masked_scan(num, cat, meas, head.lo, head.hi,
                                      head.cat)
    assert torch.equal(wide[:128], narrow)


@pytest.mark.parametrize("t,q_n,m,l,c,v,path,spl", [
    (60_000, 128, 2, 3, 3, 25, 1, 1),    # the serving shape
    (60_000, 4096, 2, 3, 3, 25, 1, 2),   # the warm-up's wide batches
    (60_000, 128, 8, 2, 1, 40, 2, 1),    # 64-bit category words
    (60_000, 4096, 0, 9, 3, 5, 0, 1),    # wider than the registers take
    (257, 33, 2, 3, 5, 4, 0, 1),
    (1, 1, 1, 0, 0, 1, 1, 1),
    (60_000, 128, 9, 9, 1, 8, 0, 1),     # phase 4's wide relation (M <= 8)
    (3001, 200, 2, 2, 2, 30_000, 3, 1)])  # category words past the smem
def test_k1_library_plan_covers_every_snippet(t, q_n, m, l, c, v, path,
                                              spl):
    """The built library's K1 plan: the path a shape takes, snippets a
    lane, every snippet and chunk in one block, K4's scratch (the plan the
    wrapper allocates from) what the launch takes, category words on path
    3 alone, shared memory within the opt-in."""
    plan = pt_fms.fused_scan_plan(t, q_n, m, l, c, v)
    assert (plan.path, plan.spl) == (path, spl)
    assert plan.n_sm == torch.cuda.get_device_properties(
        0).multi_processor_count
    assert plan.tile_q % (32 * spl) == 0
    assert plan.n_q_tiles * plan.tile_q >= q_n > (plan.n_q_tiles - 1) * (
        plan.tile_q)
    assert plan.n_chunks == -(-t // pt_fms.FMS_CHUNK_T)
    assert plan.chunks_a_block == (8 if path == 3 else 1)
    assert plan.blocks == -(-plan.n_chunks // plan.chunks_a_block) * (
        plan.n_q_tiles)
    k4 = pt_fms.masked_partials_plan(t, q_n, m)
    assert k4.scratch == (plan.n_chunks, q_n, 2 * m + 1)
    assert plan.fold_blocks == k4.fold_blocks
    assert 0 < plan.smem <= 227 * 1024
    assert (plan.word_scratch > 0) == (path == 3)
    assert plan.rows > 0


@pytest.mark.parametrize("p", [5, 17, 19, 35, 40, 64, 130])
def test_cuda_range_mask_agg_takes_any_payload_width(p):
    """K5 over any payload width in one launch (column groups of at most
    20, group widths 5, 17 (the [m, m², 1] payload of 8 measures), 19, 18,
    20 (the widest), 16 and 19): against its plain version (rtol 1e-5,
    f32), bitwise on a repeat, and each column bitwise what the kernel
    gives on that column alone."""
    _, num, cat, _, snips = _block(5000, seed=p)
    f32 = torch.float32
    payload = _measures(5000, p, seed=p).to(f32)
    extra = pt_rma.categorical_premask(cat, snips.cat)
    inputs = (num.to(f32), payload, snips.lo.to(f32), snips.hi.to(f32),
              extra)
    before = launch_counts()["range_mask_agg"]
    got = pt_rma.range_mask_agg(*inputs)
    assert launch_counts()["range_mask_agg"] == before + 1
    assert torch.equal(got, pt_rma.range_mask_agg(*inputs))
    torch.testing.assert_close(got, range_mask_agg_ref(*inputs), rtol=1e-5,
                               atol=1e-5)
    for j in range(p):
        alone = pt_rma.range_mask_agg(inputs[0], payload[:, j:j + 1],
                                      *inputs[2:])
        assert torch.equal(got[:, j:j + 1], alone), j


def _k5_inputs(t, q_n, seed, l=2, p=5):
    """K5's inputs on the card: a block's x and an f32 payload, ``q_n``
    range snippets over its ``l`` numeric dims and their categorical mask."""
    _, num, cat, meas, _ = _block(t, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (t, l)), dtype=torch.float32)
    lo = rng.uniform(0.0, 0.6, (q_n, l))
    hi = lo + rng.uniform(0.2, 0.5, (q_n, l))
    member = torch.as_tensor(rng.uniform(size=(q_n, len(CATS), max(CATS)))
                             < 0.7).cuda()
    f32 = torch.float32
    return (x.cuda(), _measures(t, p, seed).to(f32),
            torch.as_tensor(lo, dtype=f32).cuda(),
            torch.as_tensor(hi, dtype=f32).cuda(),
            pt_rma.categorical_premask(cat, member))


def test_cuda_range_mask_agg_rows_do_not_depend_on_q():
    """Rows 0..127 of a Q = 4096 launch are bitwise a Q = 128 launch."""
    x, pay, lo, hi, extra = _k5_inputs(60013, 4096, seed=51)
    wide = pt_rma.range_mask_agg(x, pay, lo, hi, extra)
    narrow = pt_rma.range_mask_agg(x, pay, lo[:128], hi[:128],
                                   extra[:, :128].contiguous())
    assert torch.equal(wide[:128], narrow)


@pytest.mark.parametrize("with_extra", [True, False])
@pytest.mark.parametrize("t,l", [(1, 2), (257, 3), (60013, 2), (257, 6),
                                 (60013, 7)])
def test_cuda_range_mask_agg_ragged_shapes(t, l, with_extra):
    """K5 at ragged T (a partial chunk, a partial ring stage), with bounds
    in registers (L <= 4) and in shared memory (L > 4), with and without
    the extra mask, against its plain version (count exact, rtol 1e-5),
    bitwise on a repeat."""
    x, pay, lo, hi, extra = _k5_inputs(t, 100, seed=t + l, l=l)
    extra = extra if with_extra else None
    got = pt_rma.range_mask_agg(x, pay, lo, hi, extra)
    want = range_mask_agg_ref(x, pay, lo, hi, extra)
    assert torch.equal(got, pt_rma.range_mask_agg(x, pay, lo, hi, extra))
    ones = pt_rma.range_mask_agg(x, torch.ones_like(pay[:, :1]), lo, hi,
                                 extra)
    assert torch.equal(ones, range_mask_agg_ref(x, torch.ones_like(
        pay[:, :1]), lo, hi, extra))
    assert t == 1 or float(ones.sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cuda_range_mask_agg_from_an_unaligned_mask():
    """A contiguous mask whose first element is 4 (not 16) bytes aligned
    takes the 4-byte copies and gives the same bits."""
    x, pay, lo, hi, extra = _k5_inputs(3000, 64, seed=53)
    flat = torch.cat([extra.new_zeros(1), extra.reshape(-1)])
    shifted = flat[1:].view(extra.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(pt_rma.range_mask_agg(x, pay, lo, hi, shifted),
                       pt_rma.range_mask_agg(x, pay, lo, hi, extra))


@pytest.mark.parametrize("t,q_n,l,p,width", [
    (1, 1, 2, 1, 1), (60013, 128, 3, 5, 5), (60013, 128, 3, 35, 18),
    (257, 33, 6, 40, 20), (257, 33, 6, 64, 16), (257, 33, 2, 130, 19)])
def test_k5_library_plan_covers_every_column_once(t, q_n, l, p, width):
    """The built library's K5 plan: one launch whose column groups cover
    every column once, in order, as few groups of at most 20 columns as
    there can be, of one width (the last group folds zero columns up to
    it); every snippet in one block of each group, shared memory within
    the opt-in."""
    plan = pt_rma.range_mask_agg_plan(t, q_n, l, p)
    assert plan.group_width == width <= 20
    assert plan.groups == -(-p // 20)
    assert plan.groups * width >= p > (plan.groups - 1) * width
    assert 1 <= plan.groups_a_block <= plan.groups
    assert plan.tiles in (1, 2, 4)
    assert plan.blocks == (-(-t // pt_rma.RMA_CHUNK_T)
                           * -(-plan.groups // plan.groups_a_block)
                           * -(-q_n // (32 * plan.tiles)))
    assert 0 < plan.smem <= 227 * 1024
    assert plan.fold_blocks == -(-q_n * p // 32)


def _pad_neutral(num, cat, lo, hi, member, n_num, v):
    """The block and snippets with numeric dims up to ``n_num`` (x = 0
    against [-inf, inf]) and one more categorical dim of ``v`` values
    (every tuple's code 0, every snippet's set full), the sets of the other
    dims widened to ``v`` values with no member past their own."""
    t, l = num.shape
    q_n = lo.shape[0]
    inf = torch.full((q_n, n_num - l), float("inf"), dtype=lo.dtype,
                     device=lo.device)
    num_p = torch.cat([num, num.new_zeros((t, n_num - l))], 1)
    cat_p = torch.cat([cat, cat.new_zeros((t, 1))], 1).contiguous()
    sets = member.new_zeros((q_n, member.shape[1] + 1, v))
    sets[:, :-1, :member.shape[2]] = member
    sets[:, -1] = True
    return (num_p, cat_p, torch.cat([lo, -inf], 1), torch.cat([hi, inf], 1),
            sets)


@pytest.mark.parametrize("m", [2, 9])
def test_cuda_k1_padded_narrow_block_takes_any_width_bitwise(m):
    """A narrow block (register path) padded with neutral dims (numeric
    dims to 9, a categorical dim of 70 values) takes the kernel for any
    width, which gives the register path's bits on the unpadded block."""
    schema, num, cat, _, _ = _block(60013, seed=61 + m)
    snips = _random_snippets(schema, 128, np.random.default_rng(61))
    meas = _measures(60013, m, seed=62)
    t_n, l = num.shape
    narrow = (num, cat, meas, snips.lo, snips.hi, snips.cat)
    assert pt_fms.fused_scan_plan(t_n, 128, min(m, 8), l, cat.shape[1],
                                  snips.cat.shape[2]).path == 1
    num_p, cat_p, lo_p, hi_p, sets = _pad_neutral(
        num, cat, snips.lo, snips.hi, snips.cat, 9, 70)
    assert pt_fms.fused_scan_plan(t_n, 128, min(m, 8), 9, cat_p.shape[1],
                                  70).path == 0
    want = pt_fms.fused_masked_scan(*narrow)
    got = pt_fms.fused_masked_scan(num_p, cat_p, meas, lo_p, hi_p, sets)
    assert float(want[:, -1].sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("l,cats,m", [(9, (8,), 9), (2, (3, 2, 5, 4, 2), 9),
                                      (12, (3, 2, 5, 4, 2), 3)])
def test_cuda_k1_any_width_holds_the_contracts(l, cats, m):
    """K1's kernel for any width at L = 9, M = 9 (phase 4's wide relation)
    and at C = 5: count exact, rtol 1e-11 of the plain version, bitwise on
    a repeat, K4 bitwise K1."""
    t, q_n = 60013, 128
    rng = np.random.default_rng(l * 7 + len(cats))
    num = torch.as_tensor(rng.uniform(0, 1, (t, l))).cuda()
    cat = torch.as_tensor(np.array([rng.integers(0, s, t) for s in cats],
                                   np.int32).T.copy()).cuda()
    meas = _measures(t, m, seed=l)
    v = max(cats)
    lo = rng.uniform(0, 0.5, (q_n, l))
    hi = lo + rng.uniform(0.4, 0.5, (q_n, l))
    member = rng.uniform(size=(q_n, len(cats), v)) < 0.8
    args = [torch.as_tensor(a).cuda() for a in (lo, hi, member)]
    assert {pt_fms.fused_scan_plan(t, q_n, count, l, len(cats), v).path
            for _, count in pt_fms.measure_groups(m)} == {0}
    got = pt_fms.fused_masked_scan(num, cat, meas, *args)
    want = fused_masked_scan_ref(num, cat, None, meas, *args)
    assert torch.equal(got, pt_fms.fused_masked_scan(num, cat, meas, *args))
    assert torch.equal(got[:, -1], want[:, -1])
    assert float(got[:, -1].sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)
    mask = pt_exec.snippet_mask(num, cat, *args)
    assert torch.equal(pt_fms.masked_partials(mask, meas), got)


def _k3_in_kernel_order(args):
    """The plain version's clamped per-dimension integrals multiplied in
    the kernels' order ((g0 g1) g2 ...) and scaled as they scale."""
    from repro_torch.kernels.se_covariance.ref import se_double_integral

    lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j = args
    g = torch.clamp(se_double_integral(lo_i[:, None, :], hi_i[:, None, :],
                                       lo_j[None], hi_j[None], ls), min=0.0)
    seq = g[..., 0]
    for k in range(1, g.shape[-1]):
        seq = seq * g[..., k]
    return sigma2 * seq / (norm_i[:, None] * norm_j[None, :])


@pytest.mark.parametrize("l", [9, 12, 17])
def test_cuda_se_cov_takes_any_l(l):
    """K3 above its templated widths (l = 17: past the 12 dims the kernels
    stage, and keep derivative chains for, at once), under its three
    contracts: the general forward's f64 per-dimension integrals are the
    plain version's (bitwise in the kernels' product order; rtol 1e-12
    against the plain forward, f32 at the reference's 2e-5 / 1e-7); the
    Gram forward is the general one bitwise; D is ``se_cov_derivs_ref``
    bitwise, from the general and the Gram forward. The gradient against
    autograd of the plain version at rtol 1e-9, the Gram route's bitwise
    the general route's. n = 70 and 45: no multiple of a tile."""
    for dtype, rtol, atol in ((torch.float64, 1e-12, 0.0),
                              (torch.float32, 2e-5, 1e-7)):
        args = _se_args(70, 45, l, seed=l, dtype=dtype)
        got = pt_se.se_cov_matrix(*args)
        assert torch.equal(got, pt_se.se_cov_matrix(*args))
        torch.testing.assert_close(got, se_cov_matrix_ref(*args), rtol=rtol,
                                   atol=atol)
        if dtype == torch.float64:
            assert torch.equal(got, _k3_in_kernel_order(args))
        sq = _se_args(70, 70, l, seed=l + 1, dtype=dtype)
        lo, hi, ls, norm = sq[0], sq[1], sq[4], sq[6]
        assert torch.equal(pt_se.se_cov_gram(lo, hi, ls, 1.7, norm),
                           pt_se.se_cov_matrix(lo, hi, lo, hi, ls, 1.7, norm,
                                               norm))
    args = _se_args(70, 45, l, seed=l + 2)
    k_mat, d = pt_se.se_cov_derivs(*args)
    assert torch.equal(k_mat, pt_se.se_cov_matrix(*args))
    assert torch.equal(d, se_cov_derivs_ref(*args)[1])
    g_out = torch.as_tensor(np.random.default_rng(l).normal(size=(70, 45)),
                            device="cuda")
    torch.testing.assert_close(pt_se.se_cov_grad(*args, g_out),
                               se_cov_grad_ref(*args, g_out), rtol=1e-9,
                               atol=0.0)
    sq = _se_args(70, 70, l, seed=l + 3)
    lo, hi, ls, norm = sq[0], sq[1], sq[4], sq[6]
    k_g, d_g = pt_se.se_cov_gram_derivs(lo, hi, ls, 1.7, norm)
    assert torch.equal(d_g, pt_se.se_cov_derivs(lo, hi, lo, hi, ls, 1.7,
                                                norm, norm)[1])
    assert torch.equal(d_g, se_cov_derivs_ref(lo, hi, lo, hi, ls, 1.7, norm,
                                              norm)[1])
    assert torch.equal(k_g, pt_se.se_cov_gram(lo, hi, ls, 1.7, norm))
    z = ls.clone().requires_grad_(True)
    g_sq = torch.as_tensor(np.random.default_rng(l + 1).normal(size=(70, 70)),
                           device="cuda")
    (via,) = torch.autograd.grad(pt_se.se_cov_gram(lo, hi, z, 1.7, norm), z,
                                 g_sq)
    assert torch.equal(via, pt_se.se_cov_grad(lo, hi, lo, hi, ls, 1.7, norm,
                                              norm, g_sq))


@pytest.mark.parametrize("l", [12, 17])
def test_cuda_se_cov_gram_derivs_takes_no_scratch(l):
    """A Gram forward with derivatives for any l allocates its outputs (K
    and D, (1 + l) n^2 numbers) and no (l, n, n) scratch."""
    n = 500
    sq = _se_args(n, n, l, seed=l + 5)
    lo, hi, ls, norm = sq[0], sq[1], sq[4], sq[6]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k_g, d_g = pt_se.se_cov_gram_derivs(lo, hi, ls, 1.7, norm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    outputs = k_g.numel() * 8 + d_g.numel() * 8
    assert outputs == 8 * (1 + l) * n * n
    assert peak < outputs + 8 * l * n * n // 2, (peak, outputs)


def test_refit_learning_sigma_on_the_card_lowers_every_nll():
    """``refit(learn_sigma=True)`` on the card: every synopsis' NLL falls,
    every Adam step through K3's Gram forward with derivatives and its
    reduction, and the fitted parameters are finite."""
    from repro_torch.aqp import workload as pt_w
    from repro_torch.core import learning
    from repro_torch.core.engine import EngineConfig, VerdictEngine

    rel = pt_w.make_relation(seed=4, n_rows=8_000, n_num=2, cat_sizes=(4,),
                             n_measures=2, device="cuda")
    eng = VerdictEngine(rel, EngineConfig(sample_rate=0.15, n_batches=4,
                                          capacity=160, seed=0))
    eng.execute_many(pt_w.make_workload(2, rel.schema, 16,
                                        agg_kinds=("AVG", "COUNT", "SUM")))
    eng.drain()
    fits = sum(syn.n >= 3 for syn in eng.store.values())
    assert fits > 1
    hists, orig = [], learning.fit

    def spy(*a, **kw):
        assert kw.get("learn_sigma") is True
        params, hist = orig(*a, **kw)
        hists.append((hist.numpy(), params))
        return params, hist

    learning.fit = spy
    before = launch_counts()
    try:
        eng.refit(steps=20, learn_sigma=True)
    finally:
        learning.fit = orig
    after = launch_counts()
    assert len(hists) == fits
    for hist, params in hists:
        assert np.isfinite(hist).all() and hist[-1] < hist[0], hist
        assert all(bool(torch.isfinite(t).all())
                   for t in (params.log_ls, params.log_sigma2, params.mu))
    for k in ("se_cov_gram", "se_cov_derivs", "se_cov_grad"):
        assert after[k] - before[k] >= 20 * fits, (k, before, after)


# ----------------------------------------------- workload intelligence
def _intel_session(cache, seed=5, **cfg):
    """A session on the card over a small relation, with ``cache``."""
    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w

    rel = pt_w.make_relation(seed=seed, n_rows=6_000, n_num=2,
                             cat_sizes=(4,), n_measures=1, device="cuda")
    base = dict(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
    base.update(cfg)
    return vd.connect(rel, vd.EngineConfig(**base), cache=cache)


def _intel_queries(s, n=6):
    import repro_torch.verdict as vd

    return [s.query().avg("v0").where(vd.between("x0", 1.0 + 0.5 * i, 9.0))
            .group_by("c0").build() for i in range(n)]


def _bits(ans):
    return [(c.group, c.estimate, c.beta2) for c in ans.cells]


def test_a_cache_hit_launches_no_kernel_on_the_card():
    """Repeats served from the answer cache move none of the kernels'
    launch counters and give the recorded answers bitwise."""
    import repro_torch.verdict as vd

    s = _intel_session(True)
    budget = vd.ErrorBudget(target_rel_error=0.5)
    qs = _intel_queries(s)
    first = s.execute_many(qs, budget)
    s.drain()
    torch.cuda.synchronize()
    before = launch_counts()
    again = [s.execute(q, budget) for q in qs]
    torch.cuda.synchronize()
    assert launch_counts() == before
    assert [a.served_from for a in again] == ["cache:exact"] * len(qs)
    assert [_bits(a) for a in again] == [_bits(a) for a in first]


def test_cache_misses_are_bitwise_a_cache_free_session_on_the_card():
    """A session with a cache answers its misses bitwise like a session
    without one fed the same misses in the same order."""
    import repro_torch.verdict as vd

    s, twin = _intel_session(True), _intel_session(None)
    budget = vd.ErrorBudget(target_rel_error=0.5)
    qs = _intel_queries(s)
    stream = qs + qs[:2] + [s.query().count().where(
        vd.between("x1", 2.0, 7.0)).build()]
    got = [s.execute(q, budget) for q in stream]
    misses = [q for q, a in zip(stream, got) if a.served_from is None]
    assert len(misses) == len(qs) + 1
    want = [twin.execute(q, budget) for q in misses]
    assert [_bits(a) for a in got if a.served_from is None] == \
        [_bits(a) for a in want]
    assert [a.batches_used for a in got if a.served_from is None] == \
        [a.batches_used for a in want]


def test_router_routes_alike_under_both_ingest_modes_on_the_card():
    """Under a budget never met the router learns to route "scan"; its
    routes and answers are the same under asynchronous and synchronous
    ingest, and every answer is bitwise an always-improve twin's."""
    import repro_torch.verdict as vd
    from repro_torch.intel import IntelConfig, RouterConfig

    tight = vd.ErrorBudget(target_rel_error=1e-9)
    runs = {}
    for mode in (True, False):
        s = _intel_session(IntelConfig(router=RouterConfig(
            probe_every=4, learn_ladder=False)), async_ingest=mode)
        twin = _intel_session(IntelConfig(router=RouterConfig(
            route_switching=False, learn_ladder=False)), async_ingest=mode)
        routes, answers = [], []
        for lo in [1.0 + 0.25 * i for i in range(8)]:
            q = s.query().avg("v0").where(vd.between("x0", lo, 9.5)).build()
            before = dict(s.stats()["intel"]["routes"])
            a, w = s.execute(q, tight), twin.execute(q, tight)
            after = s.stats()["intel"]["routes"]
            routes.append(next(r for r in after if after[r] != before[r]))
            assert _bits(a) == _bits(w) and a.batches_used == 4
            answers.append(_bits(a))
        s.drain(), twin.drain()
        runs[mode] = (routes, answers)
    assert runs[True] == runs[False]
    assert runs[True][0][0] == "improve" and "scan" in runs[True][0]


def test_a_raised_fill_floor_leaves_improved_answers_bitwise_on_the_card():
    """The router's ladder raises ``min_fill_bucket`` up to
    ``RouterConfig.max_ladder_bucket`` (512), padding the improve kernel's
    C with zero columns. Its depth split is 64 columns for every C up to
    1024 (``gp_depth_split``), so the padding adds exact zeros and the
    answers do not move."""
    import repro_torch.verdict as vd
    from repro_torch.intel import RouterConfig

    budget = vd.ErrorBudget(target_rel_error=0.5)
    runs = []
    for floor in (None, RouterConfig().max_ladder_bucket):
        s = _intel_session(None, capacity=600)
        qs = _intel_queries(s, 8)
        s.execute_many(qs[:4], budget)
        if floor is not None:
            for _, syn in s.store.items():
                syn.min_fill_bucket = floor
        runs.append([_bits(s.execute(q, budget)) for q in qs[4:]])
        s.drain()
    assert runs[0] == runs[1]


def _fill_synopsis(fill, seed):
    """An AVG synopsis of capacity 2000 on the card holding ``fill`` rows
    of random range snippets, drained."""
    from repro_torch.core.synopsis import Synopsis

    schema = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                             cat_sizes=(4,), n_measures=1)
    rng = np.random.default_rng(seed)
    syn = Synopsis(schema, capacity=2000, device="cuda")
    for _ in range(fill // 50):
        snips = _random_snippets(schema, 50, rng)
        snips = pt_types.SnippetBatch(
            snips.lo, snips.hi, snips.cat,
            torch.zeros_like(snips.agg), torch.zeros_like(snips.measure))
        syn.add(snips, torch.as_tensor(rng.normal(5.0, 1.0, 50)),
                torch.as_tensor(rng.uniform(0.01, 0.05, 50)))
    syn.drain()
    return schema, syn, rng


def test_a_fill_floor_past_1024_leaves_synopsis_improve_bitwise():
    """A fill of a few hundred rows served at the default floor (C = 1024)
    and at ``min_fill_bucket=2048`` (C = capacity = 2000): the improve
    kernel's depth split follows the fill, not the padded C, so the padded
    columns add exact zeros and the improved answers are bitwise."""
    from repro_torch.core.types import RawAnswer

    schema, syn, rng = _fill_synopsis(600, seed=21)
    assert syn.n == 600 and syn._fill_bucket() == 1024
    new = _random_snippets(schema, 40, rng)
    new = pt_types.SnippetBatch(new.lo, new.hi, new.cat,
                                torch.zeros_like(new.agg),
                                torch.zeros_like(new.measure))
    raw = RawAnswer(torch.as_tensor(rng.normal(5.0, 1.0, 40), device="cuda"),
                    torch.as_tensor(rng.uniform(0.01, 0.05, 40),
                                    device="cuda"))
    runs = []
    for floor in (8, 2048):
        syn.min_fill_bucket = floor
        out = syn.improve(new, raw)
        runs.append((out.theta, out.beta2, out.accepted))
    assert syn._fill_bucket() == 2000
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_a_router_ladder_past_1024_leaves_served_answers_bitwise():
    """The same through a session whose router has ``max_ladder_bucket=
    2048``: its ladder, fed a fill past 1024, raises every synopsis' floor
    to the capacity (2000), and the answers served after the move (no
    target: route "scan", one improve at the end) are bitwise those of a
    twin whose floors stayed."""
    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w
    from repro_torch.intel import IntelConfig, RouterConfig

    runs, fills = [], []
    for raise_floor in (False, True):
        s = _intel_session(IntelConfig(router=RouterConfig(
            max_ladder_bucket=2048, learn_ladder=False)), capacity=2000)
        warm = pt_w.make_workload(3, s.schema, 300,
                                  agg_kinds=("AVG", "COUNT", "SUM"))
        s.execute_many(warm)
        s.drain()
        fills.append({k: syn.n for k, syn in s.store.items()})
        if raise_floor:
            router = s.intel.router
            router._fill_hist[1500] = 10 ** 6
            router.apply_ladder(s.engine)
            assert router.learned_floors[1] == 2048
            assert all(syn._fill_bucket() == 2000
                       for _, syn in s.store.items())
        qs = _intel_queries(s, 8)
        runs.append([_bits(s.execute(q, vd.ErrorBudget())) for q in qs])
        s.drain()
    assert fills[0] == fills[1]
    assert any(128 < n <= 1024 for n in fills[0].values()), fills[0]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("live,q", [(600, 8), (600, 128), (1500, 8),
                                    (173, 40)])
def test_cuda_gp_batch_infer_padding_past_the_fill_is_bitwise(live, q, dtype):
    """K2 given ``live`` past rows padded to their own bucket and to C =
    2000 (Σ⁻¹ = I, k = 0, α = 0 past the fill): bitwise, and the library's
    plan covers the fill's bucket alone at both Cs."""
    bucket = pt_gp.gp_split_basis(live)
    small = _gp_args(q, live, seed=live + q, pad_c=min(bucket, 2000) - live)
    large = _gp_args(q, live, seed=live + q, pad_c=2000 - live)
    got = pt_gp.gp_batch_infer(*small, dtype=dtype, live=live)
    want = pt_gp.gp_batch_infer(*large, dtype=dtype, live=live)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for c in (min(bucket, 2000), 2000):
        plan = pt_gp.gp_plan(q, c, live)
        assert pt_gp.gp_plan_of_library(q, c, live)[:6] == (
            plan.tile_q, plan.tile_c, plan.split, plan.n_row_tiles,
            plan.n_col_tiles, plan.n_splits)
    _check_gp(got, gp_batch_infer_ref(*large), dtype, q, float(small[5][0]))


def test_the_service_answers_bitwise_its_flushes_replayed_on_the_card():
    """``Session.serve`` on the card, six threads submitting through the
    auto-flush: every ticket resolves once, and each flush's answers are
    bitwise a twin session's ``execute_many`` of the same slice; the
    flushes launched K1 once per scan round, K2 and K3."""
    import threading

    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w
    from repro_torch.kernels import reset_launch_counts

    s, twin = _intel_session(None), _intel_session(None)
    budget = vd.ErrorBudget(target_rel_error=0.05)
    qs = pt_w.make_workload(4, s.schema, 36, agg_kinds=("AVG", "COUNT",
                                                          "SUM"))
    svc = s.serve(max_batch=8, budget=budget)
    slices, rounds = [], []
    inner = svc._execute_slice

    def spy(batch):
        out = inner(batch)
        slices.append(list(batch))
        rounds.append(svc.executor.stats.eval_calls)
        return out

    svc._execute_slice = spy
    torch.cuda.synchronize()
    reset_launch_counts()
    tickets = [None] * len(qs)
    start = threading.Barrier(6)

    def submitter(k):
        start.wait()
        for i in range(k, len(qs), 6):
            tickets[i] = svc.submit(qs[i])

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.flush()
    answers = {id(q): t.result(timeout=300) for q, t in zip(qs, tickets)}
    s.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(t.resolutions == 1 for t in tickets) and svc.pending == 0
    assert sorted(id(q) for b in slices for q in b) == sorted(map(id, qs))
    assert counts["fused_masked_scan"] == sum(rounds) > 0
    assert counts["gp_batch_infer"] > 0 and counts["se_cov_matrix"] > 0
    for batch in slices:
        for q, w in zip(batch, twin.execute_many(batch, budget)):
            got = answers[id(q)]
            assert not getattr(got, "failed", False)
            assert (got.batches_used, _bits(got)) == (w.batches_used,
                                                      _bits(w))
    twin.drain()


def test_the_service_over_a_mesh_launches_k4_per_round_on_the_card():
    """``AqpService(mesh=Mesh((cuda,) * 4))``: bitwise the local service,
    through the masked-partials kernel once per scan round and never the
    fused scan."""
    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serving import AqpService

    runs = {}
    for name in ("local", "mesh"):
        s = _intel_session(None)
        kw = {"mesh": vd.Mesh((s.engine.device,) * 4)} if name == "mesh" \
            else {}
        svc = AqpService(s.engine, max_batch=64, target_rel_error=0.05, **kw)
        qs = pt_w.make_workload(6, s.schema, 12,
                                agg_kinds=("AVG", "COUNT", "SUM"))
        torch.cuda.synchronize()
        reset_launch_counts()
        res = svc.execute(qs)
        s.drain()
        torch.cuda.synchronize()
        runs[name] = (res, launch_counts(), svc.last_stats.eval_calls)
    (r_loc, c_loc, n_loc), (r_msh, c_msh, n_msh) = (runs["local"],
                                                    runs["mesh"])
    assert c_msh["masked_partials"] == n_msh > 0
    assert c_msh["fused_masked_scan"] == 0
    assert c_loc["fused_masked_scan"] == n_loc and c_loc["masked_partials"] == 0
    assert [(r.batches_used, r.tuples_scanned, r.cells) for r in r_msh] == [
        (r.batches_used, r.tuples_scanned, r.cells) for r in r_loc]


# ------------------------------------------------ launch counts, front
def test_launch_counts_add_up_when_two_threads_launch_k1():
    """Two threads launch K1 N times each, on separate blocks and streams
    of the card, at once: the count is exactly 2N launches (times K1's
    measure groups a call)."""
    import threading

    from repro_torch.kernels import reset_launch_counts

    n = 200
    blocks = [_block(5000, seed=40 + k, q_n=128) for k in range(2)]
    calls = len(pt_fms.measure_groups(blocks[0][3].shape[1]))
    start = threading.Barrier(2)
    outs = [None, None]

    def launcher(k):
        _, num, cat, meas, snips = blocks[k]
        with torch.cuda.stream(torch.cuda.Stream()):
            start.wait()
            for _ in range(n):
                outs[k] = pt_fms.fused_masked_scan(num, cat, meas, snips.lo,
                                                   snips.hi, snips.cat)
            torch.cuda.synchronize()

    torch.cuda.synchronize()
    reset_launch_counts()
    threads = [threading.Thread(target=launcher, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["fused_masked_scan"] == 2 * n * calls
    for k, (_, num, cat, meas, snips) in enumerate(blocks):
        assert torch.equal(outs[k], pt_fms.fused_masked_scan(
            num, cat, meas, snips.lo, snips.hi, snips.cat))


def _front(cache=True):
    """A serving front on the card over the small relation of
    ``_intel_session``, with a shared and an isolated tenant."""
    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w
    from repro_torch.serving.front import ServingFront, TenantSpec

    rel = pt_w.make_relation(seed=5, n_rows=6_000, n_num=2, cat_sizes=(4,),
                             n_measures=1, device="cuda")
    cfg = vd.EngineConfig(sample_rate=0.2, n_batches=4, capacity=128, seed=0)
    front = ServingFront(rel, cfg, cache=cache)
    for name in ("a", "b"):
        front.add_tenant(TenantSpec(name, isolation="shared"))
    front.add_tenant(TenantSpec("iso", isolation="isolated"))
    return front, rel, cfg


def test_the_front_miss_path_is_bitwise_a_direct_session_on_the_card():
    """Through admission and the isolated tenant's microbatch service, each
    answer is bitwise a direct CUDA session's ``execute``; the flushes
    launched K1, K2 and K3."""
    import repro_torch.verdict as vd
    from repro_torch.aqp import workload as pt_w
    from repro_torch.kernels import reset_launch_counts

    front, rel, cfg = _front()
    direct = vd.connect(rel, cfg)
    qs = pt_w.make_workload(7, rel.schema, 6,
                            agg_kinds=("AVG", "COUNT", "SUM"))
    torch.cuda.synchronize()
    reset_launch_counts()
    for q in qs:
        a, b = front.execute("iso", q), direct.execute(q)
        assert a.served_from is None and not a.failed
        assert (a.batches_used, _bits(a)) == (b.batches_used, _bits(b))
    front.tenant("iso").session.drain()
    direct.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_masked_scan"] > 0 and counts["gp_batch_infer"] > 0
    assert counts["se_cov_matrix"] + counts["se_cov_gram"] > 0


def test_a_shared_tenant_hit_launches_nothing_on_the_card():
    """Tenant ``b`` repeats each of tenant ``a``'s queries right after it
    (a full-accuracy entry serves only while its synopsis is unchanged):
    served from the shared cache, bitwise ``a``'s answer, no launch."""
    import repro_torch.verdict as vd

    front, rel, cfg = _front()
    s = vd.connect(rel, cfg)
    qs = _intel_queries(s, n=4)
    for q in qs:
        first = front.execute("a", q)
        front.tenant("a").session.drain()
        torch.cuda.synchronize()
        before = launch_counts()
        again = front.execute("b", q)
        torch.cuda.synchronize()
        assert launch_counts() == before
        assert again.served_from == "cache:exact"
        assert _bits(again) == _bits(first)
    per = front.stats()["shared_intel"]["per_tenant"]
    assert per["b"]["hits"] == len(qs) and per["a"]["hits"] == 0


def test_http_answers_are_bitwise_the_card_sessions():
    """Over HTTP on 127.0.0.1: ``/execute`` gives bitwise a CUDA twin's
    answer after the JSON round trip, and ``/stream``'s NDJSON final line
    bitwise the twin's ``execute`` under the same budget."""
    import json
    import urllib.request

    import repro_torch.verdict as vd
    from repro_torch.serving.front import (
        answer_to_json,
        budget_from_json,
        query_from_json,
        serve_http,
    )

    front, rel, cfg = _front()
    qj = {"aggs": [{"kind": "avg", "measure": "v0"}, {"kind": "count"}],
          "where": [{"op": "between", "column": "x0", "lo": 2.0, "hi": 8.0}],
          "group_by": ["c0"]}
    budget = {"target_rel_error": 0.05}
    server = serve_http(front)
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}/v1/tenants"

        def post(path, body):
            req = urllib.request.Request(base + path,
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.status == 200
                return [json.loads(line) for line in r]

        got = post("/a/execute", {"query": qj, "budget": budget})[0]
        rounds = post("/iso/stream", {"query": qj, "budget": budget})
    finally:
        server.shutdown()
        server.server_close()
    twin = vd.connect(rel, cfg)
    want = twin.execute(query_from_json(twin.schema, qj),
                        budget_from_json(budget))
    want_json = json.loads(json.dumps(answer_to_json(want)))
    assert got == want_json
    assert [r["final"] for r in rounds] == [False] * (len(rounds) - 1) + [True]
    assert rounds[-1] == want_json


# -------------------------------------------------------------- LM serving
LM_B, LM_S = 2, 16
LM_ARCHS = pt_configs.names()


def _lm_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)
    ctx = enc = None
    if cfg.cross_attn:
        ctx = rng.normal(size=(LM_B, cfg.cross_attn.n_ctx, cfg.d_model)
                         ).astype(np.float32)
    if cfg.enc_dec:
        enc = rng.normal(size=(LM_B, LM_S, cfg.d_model)).astype(np.float32)
    return tokens, ctx, enc


def _lm_n_ctx(ctx, enc):
    return ctx.shape[1] if ctx is not None else (
        LM_S if enc is not None else 0)


def _lm_forward(cfg, params, tokens, ctx, enc, dev):
    tok = torch.as_tensor(tokens, device=dev).long()
    if cfg.enc_dec:
        ctx_t = pt_lm.encode(cfg, params, torch.as_tensor(enc, device=dev))
    else:
        ctx_t = None if ctx is None else torch.as_tensor(ctx, device=dev)
    with torch.inference_mode():
        return pt_lm.forward(cfg, params, tok, ctx_tokens=ctx_t)[0]


@pytest.fixture
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_matches_prefill_on_the_card(arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(1))
    tokens, ctx, enc = _lm_inputs(cfg, 1)
    full = _lm_forward(cfg, params, tokens, ctx, enc, dev)
    prefill = pt_lm_engine.make_prefill_step(
        cfg, max_len=LM_S + cfg.meta_tokens + 4, n_ctx=_lm_n_ctx(ctx, enc))
    serve = pt_lm_engine.make_serve_step(cfg)
    last, caches = prefill(params, tokens[:, :LM_S - 1], ctx_tokens=ctx,
                           enc_embeds=enc)
    assert last.device == dev
    np.testing.assert_allclose(last.cpu().numpy(),
                               full[:, LM_S - 2].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    nxt, _ = serve(params, caches, tokens[:, LM_S - 1:],
                   LM_S - 1 + cfg.meta_tokens)
    np.testing.assert_array_equal(nxt[:, 0].cpu().numpy(),
                                  full[:, LM_S - 1].argmax(-1).cpu().numpy())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_card_matches_cpu_on_the_same_weights(arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    cpu = pt_lm_params.init_params(
        cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    card = pt_lm.Decoder(cfg, cpu).to(dev).tree()
    assert card["embed"].device == dev and cpu["embed"].device.type == "cpu"
    tokens, ctx, enc = _lm_inputs(cfg, 2)
    np.testing.assert_allclose(
        _lm_forward(cfg, card, tokens, ctx, enc, dev).cpu().numpy(),
        _lm_forward(cfg, cpu, tokens, ctx, enc, "cpu").numpy(),
        rtol=1e-5, atol=1e-4)
    got = pt_lm_engine.generate(cfg, card, tokens, 4, ctx_tokens=ctx,
                                enc_embeds=enc)
    want = pt_lm_engine.generate(cfg, cpu, tokens, 4, ctx_tokens=ctx,
                                 enc_embeds=enc, device="cpu")
    assert got.device == dev
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_lm_router_takes_tied_experts_in_index_order_on_the_card():
    from repro_torch.models import ffn as pt_lm_ffn

    cfg = pt_configs.get("arctic-480b")  # top-2 of 128, bfloat16
    dev = pt_types.resolve_device(None)
    logits = torch.zeros((64, cfg.moe.n_experts), dtype=torch.bfloat16)
    logits[:, 100:] = 1.0  # 28 tied at the top
    logits[::2, 7] = 1.0  # and a lower index tied with them
    gates, idx = pt_lm_ffn._route(cfg, logits.to(dev))
    want = torch.tensor([[7, 100], [100, 101]]).repeat(32, 1)
    assert torch.equal(idx.cpu(), want)
    assert torch.equal(gates.cpu(), torch.full((64, 2), 0.5))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "hymba-1.5b",
                                  "arctic-480b"])
def test_lm_generate_twice_gives_the_same_tokens(arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(3))
    tokens, ctx, enc = _lm_inputs(cfg, 3)
    runs = [pt_lm_engine.generate(cfg, params, tokens, 8, ctx_tokens=ctx,
                                  enc_embeds=enc) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


# ------------------------------------------------------------- LM training
TRAIN_ARCHS = ["qwen2.5-3b", "llama4-maverick-400b-a17b", "rwkv6-3b",
               "hymba-1.5b", "seamless-m4t-medium",
               "llama-3.2-vision-11b"]
TRAIN_LR = 1e-3


def _train_batch(cfg, accum, seed, dev):
    """(accum, B, S) tokens, labels from a random continuation, ctx / enc
    where the config takes them."""
    from repro_torch.data.pipeline import TokenPipeline

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=LM_S,
                         global_batch=LM_B * accum, seed=seed, over_factor=1)
    toks, labels = pipe.next_batch()
    shape = (accum, LM_B, LM_S)
    b = {"tokens": torch.as_tensor(toks.reshape(shape), device=dev).long(),
         "labels": torch.as_tensor(labels.reshape(shape), device=dev).long()}
    rng = np.random.default_rng(seed)
    if cfg.cross_attn:
        b["ctx"] = torch.as_tensor(rng.normal(
            size=shape[:2] + (cfg.cross_attn.n_ctx, cfg.d_model)).astype(
            np.float32), device=dev)
    if cfg.enc_dec:
        b["enc"] = torch.as_tensor(rng.normal(size=shape + (cfg.d_model,))
                                   .astype(np.float32), device=dev)
    return b


def _train_once(cfg, params, batch, accum=2):
    from repro_torch.training import adamw, make_train_step

    opt = adamw()
    return make_train_step(cfg, opt, accum=accum)(
        params, opt.init(params), batch, torch.tensor(TRAIN_LR))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_train_step_card_matches_cpu(arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    cpu = pt_lm_params.init_params(
        cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    card = pt_lm_params.tree_map(lambda t: t.to(dev, copy=True), cpu)
    batch = _train_batch(cfg, 2, 4, "cpu")
    card, _, got = _train_once(cfg, card, {k: v.to(dev)
                                           for k, v in batch.items()})
    cpu, _, want = _train_once(cfg, cpu, batch)
    assert got["loss"].device == dev
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)
    want_p = dict(pt_lm_params.tree_leaves(cpu))
    for path, t in pt_lm_params.tree_leaves(card):
        g, w = t.cpu().numpy(), want_p[path].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2 * TRAIN_LR,
                                   err_msg=path)
        loose = np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)
        assert loose.sum() <= max(3, 0.01 * g.size), (path, loose.sum())


def _loss_and_grads(cfg, params, batch, remat):
    import functools

    from repro_torch.models.params import tree_leaves
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.train_loop import value_and_grad

    loss, grads = value_and_grad(
        cfg, params, batch, loss_fn=functools.partial(lm_loss, remat=remat))
    return loss, [g for _, g in tree_leaves(grads)]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_recomputation_on_matches_off_on_the_card(arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(5))
    batch = {k: v[0] for k, v in _train_batch(cfg, 1, 5, dev).items()}
    l_on, g_on = _loss_and_grads(cfg, params, batch, True)
    l_off, g_off = _loss_and_grads(cfg, params, batch, False)
    np.testing.assert_allclose(float(l_on), float(l_off), rtol=1e-6)
    for a, b in zip(g_on, g_off):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * max(scale, 1e-30)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_accum_two_of_the_same_batch_is_accum_one_on_the_card(
        arch, _no_tf32):
    cfg = pt_configs.get_smoke(arch)
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(6))
    x = _train_batch(cfg, 1, 6, dev)
    clone = lambda: pt_lm_params.tree_map(torch.clone, params)  # noqa: E731
    p1, _, m1 = _train_once(cfg, clone(), x, accum=1)
    p2, _, m2 = _train_once(cfg, clone(), {k: torch.cat([v, v])
                                           for k, v in x.items()}, accum=2)
    assert np.isfinite(float(m1["loss"]))
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    other = dict(pt_lm_params.tree_leaves(p2))
    moved = False
    for path, t in pt_lm_params.tree_leaves(p1):
        assert float((t - other[path]).abs().max()) <= 1e-6, path
        moved = moved or not torch.equal(
            t, dict(pt_lm_params.tree_leaves(params))[path])
    assert moved


def test_lm_trainer_resumes_to_the_uninterrupted_loss_on_the_card(tmp_path):
    from repro_torch.launch import train as TR

    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "8", "--batch",
            "2", "--seq", "16", "--accum", "1", "--ckpt-every", "3"]
    loss_a = TR.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit):
        TR.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                        "--simulate-failure", "5"])
    assert TR.main(argv + ["--ckpt-dir", str(tmp_path / "b")]) == loss_a


def test_lm_bf16_checkpoint_round_trips_on_the_card(tmp_path):
    import dataclasses

    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.training import adamw

    cfg = dataclasses.replace(pt_configs.get_smoke("qwen2.5-3b"),
                              param_dtype="bfloat16")
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(7))
    opt = adamw()
    state = opt.init(params)
    pt_lm_params.tree_map(lambda t: t.normal_(), state["v"])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, state))
    (got_p, got_s), _ = mgr.restore(
        (pt_lm_params.tree_map(torch.zeros_like, params), opt.init(params)))
    for (path, a), (_, b) in zip(pt_lm_params.tree_leaves([params, state]),
                                 pt_lm_params.tree_leaves([got_p, got_s])):
        assert b.device == dev and b.dtype == a.dtype, path
        assert torch.equal(a, b), path


# ------------------------------------------- the static checker's trace layer
def test_trace_layer_is_clean_on_the_card():
    """T001-T007 over the nine programs and the improve ladder on the card:
    no gating finding, and K1, K4 and K2 ran under them."""
    from repro_torch.analysis.findings import INFO, gate_count, render_text
    from repro_torch.analysis.trace_rules import run_trace_rules
    from repro_torch.kernels import reset_launch_counts

    reset_launch_counts()
    found = run_trace_rules(device="cuda")
    counts = launch_counts()
    assert gate_count(found, strict=True) == 0, render_text(found)
    # the fused programs fold inside K1 and K4, noted as info
    assert {(f.rule, f.location) for f in found if f.severity == INFO} == {
        ("T001", "program:eval_partials_fused"),
        ("T001", "program:masked_partials_fused")}
    for k in ("fused_masked_scan", "masked_partials", "gp_batch_infer"):
        assert counts[k] > 0, counts


@pytest.mark.parametrize("t_n,q_n", [(20_000, 128), (20_000, 1024)])
def test_t005_memory_delta_on_k1_stays_below_the_mask(t_n, q_n):
    """The fused scan on the card creates no (T, Q) tensor and peaks below
    T * Q * 8 bytes; the plain scan under the ``fused`` tag is flagged."""
    from repro_torch.analysis.programs import Program
    from repro_torch.analysis.trace_rules import check_no_tq_buffer

    _, num, cat, meas, snips = _block(t_n, seed=3, q_n=q_n)
    fused = Program("eval_partials_fused", pt_fms.eval_partials_fused,
                    (num, cat, meas, snips), frozenset({"fused"}), t=t_n,
                    q=q_n, device=num.device)
    assert check_no_tq_buffer(fused) == []
    trace = fused.trace()
    assert 0 < trace.peak_bytes < t_n * q_n * 8
    assert trace.launches["fused_masked_scan"] >= 1
    plain = Program("oracle_as_fused", pt_exec.eval_partials,
                    (num, cat, meas, snips), frozenset({"fused"}), t=t_n,
                    q=q_n, device=num.device)
    found = check_no_tq_buffer(plain)
    assert [f.rule for f in found] == ["T005", "T005"]  # shapes and memory
    assert plain.trace().peak_bytes >= t_n * q_n * 8


def test_t007_reads_k2_plans_of_the_built_library():
    """The improve ladder on the card: one K2 launch signature (shapes and
    the library's ``gp_plan``) per (Q, fill) bucket pair; K1's launch keyed
    by shape alone."""
    from repro_torch.analysis.programs import CallTap
    from repro_torch.analysis.trace_rules import (
        check_improve_cache_cardinality, check_scan_launch_cache,
        gp_signature)
    from repro_torch.kernels import reset_launch_counts

    reset_launch_counts()
    assert check_improve_cache_cardinality(device="cuda") == []
    assert launch_counts()["gp_batch_infer"] == 16
    assert check_scan_launch_cache(device="cuda") == []
    k = torch.zeros((8, 16), dtype=torch.float64, device="cuda")
    with CallTap(pt_gp.gp_batch_infer) as tap:
        pt_gp.gp_batch_infer(k, torch.eye(16, dtype=torch.float64,
                                          device="cuda"),
                             *(torch.ones(n, dtype=torch.float64,
                                          device="cuda")
                               for n in (16, 8, 8, 8, 8)), live=13)
    sig = gp_signature(tap.calls[0][1])
    assert sig[-1] == pt_gp.gp_plan_of_library(8, 16, 13)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_t003_mask_build_is_shard_local_on_the_card(n_shards):
    from repro_torch.analysis.programs import sharded_mask_program
    from repro_torch.analysis.trace_rules import (
        check_mask_build_collectives, cross_shard_ops)

    p = sharded_mask_program("cuda", n_shards=n_shards)
    assert len(set(p.trace().shards.values())) == n_shards
    assert check_mask_build_collectives(p) == []
    assert cross_shard_ops(p.trace()) == []


# ------------------------------------------------------- distributed layer
def _card_mesh(shape, axes):
    dev = pt_types.resolve_device(None)
    return pt_exec.Mesh((dev,) * int(np.prod(shape)), axes, shape)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("cap", [1.0, 1.25])
def test_mesh_moe_on_the_card_is_each_batch_shard_alone(shape, cap,
                                                        _no_tf32):
    """arctic-smoke's MoE layer over a (data, model) mesh of the card: each
    batch shard's single-device MoE (the same local capacity), within
    float32 rounding; two runs bitwise."""
    import dataclasses

    from repro_torch.models import ffn as pt_lm_ffn
    from repro_torch.models.common import ShardCtx

    cfg = pt_configs.get_smoke("arctic-480b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap))
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(2))
    p = pt_lm_params.tree_map(lambda t: t[0],
                              params["groups"][0]["sub0"]["moe"])
    x = torch.randn((4, 9, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    sctx = ShardCtx(mesh=_card_mesh(shape, ("data", "model")))
    got = pt_lm_ffn.moe_ffn(cfg, p, x, sctx)
    assert got.device == dev
    assert torch.equal(got, pt_lm_ffn.moe_ffn(cfg, p, x, sctx))
    rows = 4 // shape[0]
    want = torch.cat([pt_lm_ffn.moe_ffn(cfg, p, x[i * rows:(i + 1) * rows])
                      for i in range(shape[0])])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _watch_exchange(monkeypatch):
    from repro_torch.distributed import compression as C

    seen = []
    real = C.ppermute

    def spy(xs, mesh, axis, perm):
        seen.append(xs)
        return real(xs, mesh, axis, perm)

    monkeypatch.setattr(C, "ppermute", spy)
    return seen


def test_compressed_step_on_the_card_steps_a_replicated_leaf_once(
        monkeypatch, _no_tf32):
    """qwen-smoke over (pod 2, data 1, model 1) of the card: the pods read
    one parameter tree (replicas alias), which the step updates once: the
    result equals one AdamW update of a copy with the exchanged mean, the
    payloads are int8 with a float32 scale a leaf, and the loss is the
    pods' mean."""
    from repro_torch.distributed import compression as C
    from repro_torch.training import adamw
    from repro_torch.training.train_loop import (accumulated_grads,
                                                 clip_in_place)

    cfg = pt_configs.get_smoke("qwen2.5-3b")
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(5))
    before = pt_lm_params.tree_map(lambda t: t.clone(), params)
    mesh = _card_mesh((2, 1, 1), ("pod", "data", "model"))
    batch = _train_batch(cfg, 1, 4, dev)
    seen = _watch_exchange(monkeypatch)
    opt = adamw()
    state = opt.init(params)
    _, _, met = C.make_compressed_train_step(cfg, opt, mesh)(
        params, state, batch, torch.tensor(TRAIN_LR))
    assert int(state["step"]) == 1
    (payloads,) = seen
    n = len(pt_lm_params.tree_leaves(params))
    for pod in payloads:
        assert len(pod) == n
        for q, s in pod:
            assert q.dtype == torch.int8 and s.dtype == torch.float32
    means = [(C.dequantize(*a) + C.dequantize(*b)) / 2
             for a, b in zip(payloads[0], payloads[1])]
    it = iter(means)
    grads = pt_lm_params.tree_map(lambda _: next(it), before)
    clip_in_place(grads, 1.0)
    once = pt_lm_params.tree_map(lambda t: t.clone(), before)
    opt.update(grads, opt.init(once), once, torch.tensor(TRAIN_LR))
    want = dict(pt_lm_params.tree_leaves(once))
    for path, t in pt_lm_params.tree_leaves(params):
        assert torch.equal(t, want[path]), path
    rows = LM_B // 2
    losses = [float(accumulated_grads(
        cfg, before, {k: v[:, i * rows:(i + 1) * rows]
                      for k, v in batch.items()})[0]) for i in range(2)]
    assert float(met["loss"]) == pytest.approx(sum(losses) / 2, rel=1e-6)


def test_elastic_reshard_through_a_checkpoint_on_the_card(tmp_path):
    """qwen-smoke in bf16 with an AdamW state placed under FSDP_RULES on
    (data 4, model 1) of the card, saved, restored and resharded onto
    (data 2, model 1): bitwise the originals, every shard on the card."""
    import dataclasses

    from repro_torch.distributed import sharding as SH
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.elastic import reshard
    from repro_torch.training import adamw

    cfg = dataclasses.replace(pt_configs.get_smoke("qwen2.5-3b"),
                              param_dtype="bfloat16")
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(6))
    state = adamw().init(params)
    pt_lm_params.tree_map(lambda t: t.normal_(), state["m"])

    def shardings(data):
        mesh = _card_mesh((data, 1), ("data", "model"))
        ps = pt_lm_params.shardings(cfg, mesh, SH.FSDP_RULES)
        return ps, SH.opt_state_shardings("adamw", ps, state)

    placed = SH.device_put((params, state), shardings(4))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, placed)
    restored, _ = mgr.restore(placed)
    moved = reshard(restored, shardings(2))
    for _, t in pt_lm_params.tree_leaves(list(moved)):
        assert len(t.shards) == 2 and all(s.device == dev for s in t.shards)
    got = SH.device_get(moved, dev)
    for (_, a), (_, b) in zip(pt_lm_params.tree_leaves(list(got)),
                              pt_lm_params.tree_leaves([params, state])):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


def test_host_mesh_lists_the_visible_cards():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    m = make_host_mesh()
    assert m.shape == {"data": torch.cuda.device_count()}
    assert all(d.type == "cuda" for d in m.devices)
    if torch.cuda.device_count() < 256:
        with pytest.raises(ValueError, match="must be >= the product"):
            make_production_mesh()


def test_scan_over_one_axis_of_a_card_mesh_launches_k4():
    """A block over the data axis of a (data 2, model 2) mesh of the card:
    bitwise the two-shard mesh, through the masked-partials kernel."""
    from repro_torch.kernels import reset_launch_counts

    _, num, cat, meas, snips = _block(5000, seed=8, q_n=128)
    two = _card_mesh((2, 2), ("data", "model"))
    one = pt_exec.Mesh((num.device,) * 2)
    reset_launch_counts()
    got = pt_exec.eval_partials_sharded(two, num, cat, meas, snips,
                                        axis="data")
    assert launch_counts()["masked_partials"] >= 1
    want = pt_exec.eval_partials_sharded(one, num, cat, meas, snips)
    for f in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ------------------------------------------------------------ launch layer
def _flops(fn, args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def test_launch_decode_probe_on_the_card_counts_the_meta_flops():
    """qwen2.5-3b decode_32k's layer probe at its cell's shapes on the card
    (batch 128, a 32,784-slot bf16 cache: 4.3 GB of k and v): finite
    outputs of the reference's shapes, the cache written in place, and
    the FLOPs ``FlopCounterMode`` counts on the card equal to those it
    counts on meta."""
    from repro_torch.launch import cells as C
    from repro_torch.launch.mesh import make_production_mesh

    dev = pt_types.resolve_device(None)
    cell = C.build_cell("qwen2.5-3b", "decode_32k",
                        make_production_mesh(device="meta"), False)
    ((label, mult, fn, args),) = cell.probes
    assert (label, mult) == ("groups0_dec", 35)
    meta_flops, _ = _flops(fn, C.call_args(args, pos=40000))
    g = torch.Generator(device=dev).manual_seed(0)
    real = C.call_args(args, dev, g, pos=40000)
    flops, (out, cache) = _flops(fn, real)
    assert flops == meta_flops > 0
    assert out.shape == (128, 1, 2048) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    assert cache is real[2]
    # slot_pos starts as arange (every slot valid); the step writes slot
    # 40000 % 32784
    assert int(cache["sub0"]["attn"]["slot_pos"][40000 % 32784]) == 40000


def test_launch_chunk_probes_on_the_card_count_the_meta_flops():
    """rwkv6-3b train_4k's chunk probes (float32, micro 16, a chunk of
    16): the card's FLOPs equal meta's, gradients finite."""
    from repro_torch.launch import cells as C
    from repro_torch.launch.mesh import make_production_mesh

    dev = pt_types.resolve_device(None)
    cell = C.build_cell("rwkv6-3b", "train_4k",
                        make_production_mesh(device="meta"), False)
    g = torch.Generator(device=dev).manual_seed(1)
    for label, _, fn, args in cell.probes:
        if not label.startswith("ssm_chunk"):
            continue
        meta_flops, _ = _flops(fn, C.call_args(args))
        flops, out = _flops(fn, C.call_args(args, dev, g))
        assert flops == meta_flops > 0, label
        for t in pt_lm_params.tree_leaves(list(out)):
            assert bool(torch.isfinite(t[1]).all()), label


def test_launch_moe_collectives_on_a_card_listed_four_times():
    """arctic-smoke's MoE layer over a (data 2, model 2) mesh of the card
    listed four times: one all-reduce of (rows, d) float32 a layer call,
    wire bytes twice that; recording changes no output."""
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import ffn as pt_lm_ffn
    from repro_torch.models.common import ShardCtx

    cfg = pt_configs.get_smoke("arctic-480b")
    dev = pt_types.resolve_device(None)
    params = pt_lm_params.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(2))
    p = pt_lm_params.tree_map(lambda t: t[0],
                              params["groups"][0]["sub0"]["moe"])
    x = torch.randn((4, 8, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    sctx = ShardCtx(mesh=_card_mesh((2, 2), ("data", "model")))
    plain = pt_lm_ffn.moe_ffn(cfg, p, x, sctx)
    with H.record_collectives() as rec:
        got = pt_lm_ffn.moe_ffn(cfg, p, x, sctx)
    assert torch.equal(got, plain)
    out = H.collective_bytes(rec)
    rows = 4 * 8 // 2
    assert out["bytes_by_kind"] == {"all-reduce": rows * cfg.d_model * 4}
    assert out["op_counts"] == {"all-reduce": 1}
    assert out["wire_bytes_total"] == 2 * rows * cfg.d_model * 4


# ------------------------------------------------------- group discovery
GD_T = 599_861  # the first sample batch at TPC-H SF10 (the benchmark's cell)
GD_CATS = (3, 2, 25)  # returnflag, linestatus, nation


def _gd_inputs(n_probes, seed):
    """The cell's first batch (3 numeric dims, 3 categorical) and
    ``n_probes`` COUNT probes with random windows and category sets,
    grouped in turn by returnflag, nation and all three columns."""
    from repro_torch.aqp import queries as Q
    from repro_torch.core.types import SnippetBatch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (GD_T, 3)), device="cuda")
    codes = torch.as_tensor(np.stack(
        [rng.integers(0, s, GD_T) for s in GD_CATS], 1).astype(np.int32),
        device="cuda")
    schema = pt_types.Schema((0.0,) * 3, (1.0,) * 3, GD_CATS, 1)
    probes, groupby = [], []
    for p in range(n_probes):
        a = rng.uniform(0, 0.8, 3)
        preds = [Q.NumRange(k, a[k], a[k] + rng.uniform(0.05, 0.2))
                 for k in range(3) if rng.random() < 0.7]
        if p % 5 == 4:
            preds.append(Q.CatIn(2, tuple(rng.choice(25, 4, replace=False)
                                          .tolist())))
        probes.append(Q.decompose(schema, Q.AggQuery(
            aggs=(Q.AggSpec("COUNT"),), predicates=tuple(preds))).snippets)
        groupby.append([(0,), (2,), (0, 1, 2)][p % 3])
    return x, codes, SnippetBatch.concat(probes), groupby


@pytest.mark.parametrize("n_probes", [1, 16])
@pytest.mark.parametrize("bound", ["default", 30, 0])
def test_cuda_group_discovery_matches_plain_version(n_probes, bound,
                                                    monkeypatch):
    """The kernel against its plain version at the cell's shape (599,861
    tuples; returnflag, nation and all three columns): equal presence and
    keys, bitwise across runs, and equal groups. ``bound`` cuts the table
    route's bound: at 30 the first two probes' tables (3 and 25 keys) fill
    it and every later probe takes the sorted route; 0 sends every probe
    there."""
    from repro_torch.core.engine import discover_groups
    from repro_torch.kernels import RANGE_EPS
    from repro_torch.kernels.group_discovery import ops as gd_ops
    from repro_torch.kernels.group_discovery.ref import group_discovery_ref

    if bound != "default":
        monkeypatch.setattr(gd_ops, "GD_TABLE_KEYS", bound)
    x, codes, probes, groupby = _gd_inputs(n_probes, seed=11 + n_probes)
    plan = gd_ops.discovery_plan(groupby, GD_CATS)
    assert (plan.n_rows == 0) == (bound == "default" or n_probes == 1
                                  and bound == 30)
    lo = (probes.lo - RANGE_EPS).cuda()
    hi = (probes.hi + RANGE_EPS).cuda()
    member = probes.cat.cuda()
    before = launch_counts()["group_discovery"]
    got = gd_ops.group_discovery(x, codes, lo, hi, member, plan)
    again = gd_ops.group_discovery(x, codes, lo, hi, member, plan)
    torch.cuda.synchronize()
    assert launch_counts()["group_discovery"] == before + 2
    meta = [torch.as_tensor(a, device="cuda")
            for a in (plan.gcol, plan.gstride, plan.route)]
    want = group_discovery_ref(x, codes, lo, hi, member, *meta, plan.n_keys,
                               plan.n_rows)
    for name, g, a, w in zip(("presence", "keys"), got, again, want):
        assert torch.equal(g, w), name
        assert torch.equal(a, w), name
    groups = discover_groups(x, codes, probes, groupby, GD_CATS)
    assert groups == discover_groups(x.cpu(), codes.cpu(), probes, groupby,
                                     GD_CATS)
    assert all(groups), "every probe admits some tuple"


def test_a_group_by_execute_many_launches_one_discovery_and_copies_marks():
    """A workload of group-by and plain queries on the card: its discovery
    is one launch and one copy to the host, the presence table's bytes,
    and its groups equal the plain version's on the CPU; the whole
    ``execute_many`` launches discovery once and copies the table plus the
    answers, under 1 MB (the padded mask of the first batch alone was
    T x 128 x 8 bytes, 6.1 MB here)."""
    import dataclasses

    from repro_torch.aqp import workload as pt_w
    from repro_torch.core.engine import EngineConfig, VerdictEngine
    from repro_torch.utils import tracing

    cfg = EngineConfig(sample_rate=0.2, n_batches=4, capacity=128, seed=0,
                       learning=False)
    rel = pt_w.tpch_like(3, n_rows=150_000, device="cuda")
    eng = VerdictEngine(rel, cfg)
    cpu = VerdictEngine(pt_w.tpch_like(3, n_rows=150_000, device="cpu"),
                        cfg, device="cpu")
    qs = pt_w.tpch_workload(4, rel.schema, 12)
    qs = [dataclasses.replace(q, groupby=(0, 2)) if i % 4 == 3 else q
          for i, q in enumerate(qs)]
    n_grouped = sum(bool(q.groupby) for q in qs)
    assert n_grouped >= 2 and n_grouped < len(qs)
    torch.cuda.synchronize()
    tracing.reset()
    tracing.enable()
    try:
        before = launch_counts()["group_discovery"]
        groups = eng._discover_groups_many(qs)
        copies = tracing.counters()
        tracing.reset()
        eng.execute_many(qs)
        torch.cuda.synchronize()
        flush = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert groups == cpu._discover_groups_many(qs)
    plan_keys = sum(3 if q.groupby == (0,) else 75 for q in qs if q.groupby)
    assert copies["host_copy.count"] == 1
    assert copies["host_copy.bytes"] == plan_keys
    assert copies["discover.table"] == n_grouped
    assert copies["discover.sorted"] == 0
    assert launch_counts()["group_discovery"] == before + 2
    assert flush["host_copy.bytes"] < 1 << 20
