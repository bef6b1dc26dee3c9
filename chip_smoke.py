#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Verdict on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device and build: card name and power limit, nvcc build of every kernel
     under src/repro_torch/csrc (timed), TF32 off;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with CUDA-event timings and bounds (the
     SE-covariance forward and its lengthscale gradient included);
  3. the main path at a size users run: TPC-H SF1 lineitem cardinality
     (6,001,215 rows), capacity 2000, a 2000-query warm-up through
     ``execute_many`` and 200 queries served one by one through ``execute``;
  6. learning and checkpoints on phase 3's engine: ``refit()`` with its
     defaults (the NLL must fall on every synopsis; every Adam step runs the
     SE-covariance forward and gradient kernels), ``save_synopses`` /
     ``load_synopses`` into a fresh engine (bitwise state, then 20 queries
     answered bitwise alike), 200 fresh queries after the refit, and a
     drifted data append on every synopsis;
  5. the ``connect``/``Session`` facade on phase 3's relation, locally and
     over a four-shard ``Mesh`` on the one card: the mesh session must
     answer bitwise like the local one and scan through the
     ``masked_partials`` kernel once per round, also after
     ``Session.refit()``; then the ``range_mask_agg`` kernel through the
     scan placement over every sample batch, against the fused scan;
  4. the slice against its plain path: a CUDA engine and a CPU engine on the
     same 600,000-row data must agree, before and after a short refit of
     both (run last; phases 6 and 5 reuse phase 3's relation).
The last two lines of standard output are the kernels' JSON record and the
device record ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM data sheet: float64 at 67 TFLOP/s through the DMMA tensor cores
# (full f64 precision); float32 at 67 TFLOP/s outside the tensor cores
# (their TF32 rate is for a lower precision). Work that cannot use the
# tensor cores (K3: division, exp, erf) is bounded by the non-tensor float64
# rate, 34 TFLOP/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "float64_simt": 34e12}
# A flipped decision passes only if its input (the largest relative error
# for the stop test, the model answer for validation) lay within this factor
# of the largest difference the engines showed in that input on the
# decisions they agreed on; 4 leaves room for the flipped query's own
# difference to exceed those seen before it.
FLIP_FACTOR = 4.0
K1_REPLACES = "src/repro/kernels/fused_masked_scan/kernel.py:84"
K2_REPLACES = "src/repro/kernels/gp_batch_infer/kernel.py:27"
K4_REPLACES = "src/repro/kernels/fused_masked_scan/kernel.py:133"
K5_REPLACES = "src/repro/kernels/range_mask_agg/kernel.py:25"
K3_REPLACES = "src/repro/kernels/se_covariance/kernel.py:35"
SYNOPSIS_C = 2000  # synopsis capacity of phases 3 and 6 (a full rebuild)
PHASE4_REFIT_STEPS = 30  # phase 4 refits the CPU engine too: few steps
SF1_BATCH_T = 60_013  # tuples in one sample batch of phase 3's SF1 sample


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=20, inner=1, warmup=3):
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls, per call (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        samples.append(s.elapsed_time(e) / inner)
    return float(np.median(samples))


def device_profile(fn, n=1):
    """Run ``fn`` ``n`` times under ``torch.profiler``. Returns the host wall
    time of the window (s), the device busy time (the union of the device
    activity intervals, s) and ``{name: [count, device s]}`` per kernel or
    copy. The profiler's own host cost is inside the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end  # microseconds
        spans.append((s, t))
        rec = per.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t - s) * 1e-6
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return wall, busy * 1e-6, per


def _short(name):
    return name.replace("(anonymous namespace)::", "").split("(")[0][:48]


def device_ms_per_call(label, fn, n=10):
    """Device time per call of ``fn`` from the profiler, with its split by
    kernel; None when the profiler saw no device activity."""
    wall, busy, per = device_profile(fn, n)
    if not per:
        log(f"  {label}: the profiler recorded no device activity "
            "(device time not measured)")
        return None
    log(f"  {label}: device {1e3 * busy / n:.6f} ms per call (" + ", ".join(
        f"{_short(k)} {1e3 * v[1] / n:.6f} ms x{v[0] / n:g}"
        for k, v in sorted(per.items(), key=lambda kv: -kv[1][1]))
        + f"); host wall {1e3 * wall / n:.6f} ms per call under the profiler")
    return 1e3 * busy / n


def bound(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(name, shape, ms, plain_ms, n_bytes, n_ops, dtype, err,
           library_ms=None):
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    lib = "null" if library_ms is None else f"{library_ms:.6f}"
    log(f"  {name} {shape}: kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
        f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
        f"max_abs_err={err:.3e} library_ms={lib}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "library_ms": library_ms}


# ------------------------------------------------------------------ phase 1
def phase_build():
    import torch
    from repro_torch import kernels

    log("== phase 1: device and build")
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    log("device:", torch.cuda.get_device_name(0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log("nvidia-smi:", smi)
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, out in logs.items():
        log(f"-- nvcc {name}:\n{out.strip()}")
    log(f"built {sorted(logs) or 'nothing (up to date)'} in {build_s:.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)
    return smi


# ------------------------------------------------------------------ phase 2
def _fused_snippets(rel, seed, n_queries, q_n):
    """The first ``q_n`` distinct snippets of a tpch workload (host)."""
    from repro_torch.aqp import queries as Q
    from repro_torch.aqp.plan import SnippetInterner
    from repro_torch.aqp.workload import tpch_workload

    interner = SnippetInterner(rel.schema)
    for q in tpch_workload(seed, rel.schema, n_queries):
        groups = [(g,) for g in range(3)] if q.groupby else [()]
        interner.intern(Q.decompose(rel.schema, q, groups).snippets)
    fused = interner.fused()
    if fused.n < q_n:
        raise RuntimeError(f"workload gave {fused.n} snippets < {q_n}")
    return fused[np.arange(q_n)]


def check_k1(rel, seed):
    import torch
    from repro_torch.aqp.executor import eval_partials
    from repro_torch.core.types import make_snippets
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import fused_masked_scan_ref

    log("-- K1 fused_masked_scan (f64): count and scanned exact, "
        "sums/sumsq rtol 1e-11, repeat bitwise")
    dev = rel.device
    rows = np.random.default_rng(seed).permutation(rel.cardinality)[:60_000]
    blk = rel.take(rows)
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    t_n, l = x.shape
    c, m = codes.shape[1], meas.shape[1]
    records = {}
    for q_n in (128, 4096):
        s = _fused_snippets(rel, seed, 2000, q_n).to(dev)
        args = (x, codes, meas, s.lo, s.hi, s.cat)
        got = fms.fused_masked_scan(*args)
        again = fms.fused_masked_scan(*args)
        want = fused_masked_scan_ref(x, codes, None, meas, s.lo, s.hi, s.cat)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "K1 is not bitwise across runs"
        assert torch.equal(got[:, -1], want[:, -1]), "K1 count differs"
        assert torch.allclose(got[:, :-1], want[:, :-1], rtol=1e-11, atol=0.0)
        kp = fms.eval_partials_fused(x, codes, meas, s)
        pp = eval_partials(x, codes, meas, s)
        assert torch.equal(kp.scanned, pp.scanned) and torch.equal(
            kp.count, pp.count)
        err = float((got - want).abs().max())
        v = s.cat.shape[2]
        ms = time_ms(lambda: fms.fused_masked_scan(*args), inner=10)
        plain = time_ms(lambda: fused_masked_scan_ref(
            x, codes, None, meas, s.lo, s.hi, s.cat), reps=20 if q_n <= 128
            else 5)
        n_bytes = (t_n * (8 * l + 4 * c + 8 * m) + q_n * (16 * l + c * v)
                   + q_n * (2 * m + 1) * 8)
        n_ops = t_n * q_n * (2 * l + c + 2 * (2 * m + 1))
        records[q_n] = report("fused_masked_scan", f"T={t_n} Q={q_n}", ms,
                              plain, n_bytes, n_ops, "float64", err)
        records[q_n]["device_ms"] = device_ms_per_call(
            f"fused_masked_scan Q={q_n}", lambda: fms.fused_masked_scan(*args))
    # Boundary: x exactly at lo, inside and outside the 1e-12 widening.
    sch = rel.schema
    snip = make_snippets(sch, agg=[0], measure=[0],
                         num_ranges=[{0: (0.5 * sch.num_hi[0],
                                          0.9 * sch.num_hi[0])}]).to(dev)
    offsets = (0.0, 1e-12, -1e-12, 1e-7, -1e-7, -5e-8, -3e-12)
    want_in = 4.0  # 0, +1e-12, -1e-12, +1e-7
    xb = torch.tensor([[0.5 + d, 0.5, 0.5] for d in offsets],
                      dtype=torch.float64, device=dev)
    cb = torch.zeros((len(offsets), c), dtype=torch.int32, device=dev)
    mb = torch.ones((len(offsets), m), dtype=torch.float64, device=dev)
    kb = fms.fused_masked_scan(xb, cb, mb, snip.lo, snip.hi, snip.cat)
    pb = fused_masked_scan_ref(xb, cb, None, mb, snip.lo, snip.hi, snip.cat)
    assert float(kb[0, -1]) == float(pb[0, -1]) == want_in, (kb, pb)
    # A block with zero valid rows contributes exactly nothing.
    s = _fused_snippets(rel, seed, 200, 128).to(dev)
    zero = torch.zeros((t_n,), dtype=torch.float64, device=dev)
    kz = fms.eval_partials_fused(x, codes, meas, s, valid=zero)
    assert float(kz.scanned) == 0.0 and not bool(kz.count.any())
    assert not bool(kz.sums.any()) and not bool(kz.sumsq.any())
    log("  boundary (lo, lo±1e-12, lo±1e-7) and zero-valid block: ok")
    return records


def check_k2(seed, dev):
    import torch
    from repro_torch.kernels.gp_batch_infer import ops as gp
    from repro_torch.kernels.gp_batch_infer.ref import gp_batch_infer_ref

    log("-- K2 gp_batch_infer: f64 rtol 1e-10; f32 rtol 5e-3 atol 5e-5 "
        "against the f64 plain version")
    records = {}
    c = 2000
    for q in (8, 128):
        rng = np.random.default_rng(seed + q)
        a = rng.normal(size=(c, c))
        sinv = a @ a.T / c + np.eye(c)
        k = rng.normal(0, 0.1, (q, c))
        alpha = rng.normal(0, 1, (c,))
        kappa2 = np.einsum("qc,cd,qd->q", k, sinv, k) + rng.uniform(0.05, 0.5,
                                                                    q)
        mu = rng.normal(0, 1, (q,))
        rawt = rng.normal(0, 1, (q,))
        rawb = rng.uniform(0.0, 0.3, (q,))
        rawb[0] = 0.0  # the exact-raw branch
        args = [torch.as_tensor(v, dtype=torch.float64, device=dev)
                for v in (k, sinv, alpha, kappa2, mu, rawt, rawb)]
        want = gp_batch_infer_ref(*args)
        for dt, rtol, atol in ((torch.float64, 1e-10, 0.0),
                               (torch.float32, 5e-3, 5e-5)):
            got = gp.gp_batch_infer(*args, dtype=dt)
            again = gp.gp_batch_infer(*args, dtype=dt)
            torch.cuda.synchronize()
            assert all(torch.equal(g, h) for g, h in zip(got, again))
            err = 0.0
            for g, w in zip(got, want):
                assert torch.allclose(g.double(), w, rtol=rtol, atol=atol), (
                    dt, q, float((g.double() - w).abs().max()))
                err = max(err, float((g.double() - w).abs().max()))
            assert float(got[0][0]) == float(rawt[0].astype(
                np.float32 if dt == torch.float32 else np.float64))
            assert float(got[1][0]) == 0.0
            argd = [v.to(dt) for v in args]
            ms = time_ms(lambda: gp.gp_batch_infer(*argd, dtype=dt), inner=10)
            plain = time_ms(lambda: gp_batch_infer_ref(*argd), inner=10)
            size = 8 if dt == torch.float64 else 4
            n_bytes = size * (q * c + c * c + c + 4 * q + 3 * q)
            n_ops = 2 * q * c * c + 4 * q * c
            name = str(dt).replace("torch.", "")
            records[(q, name)] = report("gp_batch_infer", f"Q={q} C={c} "
                                        f"{name}", ms, plain, n_bytes, n_ops,
                                        name, err)
            records[(q, name)]["device_ms"] = device_ms_per_call(
                f"gp_batch_infer Q={q} {name}",
                lambda: gp.gp_batch_infer(*argd, dtype=dt))
    return records


def check_k4(rel, seed):
    import torch
    from repro_torch.aqp.executor import payload_of, predicate_mask
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import masked_partials_ref

    log("-- K4 masked_partials (f64): count exact, sums/sumsq rtol 1e-11, "
        "repeat bitwise, bitwise K1 on the same block")
    rows = np.random.default_rng(seed + 7).permutation(rel.cardinality)
    blk = rel.take(rows[:SF1_BATCH_T])
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    t_n, m = meas.shape
    records = {}
    for q_n in (128, 4096):
        s = _fused_snippets(rel, seed, 2000, q_n).to(rel.device)
        mask = predicate_mask(x, codes, s)  # (T, Q) 0/1, as the mesh builds
        got = fms.masked_partials(mask, meas)
        again = fms.masked_partials(mask, meas)
        want = masked_partials_ref(mask, meas)
        k1 = fms.fused_masked_scan(x, codes, meas, s.lo, s.hi, s.cat)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "K4 is not bitwise across runs"
        assert torch.equal(got[:, -1], want[:, -1]), "K4 count differs"
        assert torch.allclose(got[:, :-1], want[:, :-1], rtol=1e-11, atol=0.0)
        assert torch.equal(got, k1), "K4 on the block's mask is not K1's bits"
        err = float((got - want).abs().max())
        ms = time_ms(lambda: fms.masked_partials(mask, meas), inner=10)
        plain = time_ms(lambda: masked_partials_ref(mask, meas),
                        reps=20 if q_n <= 128 else 5)
        payload = payload_of(meas)
        lib = time_ms(lambda: mask.T @ payload, inner=10)
        p = 2 * m + 1
        n_bytes = 8 * (t_n * q_n + t_n * m + q_n * p)
        n_ops = 2 * t_n * q_n * p
        records[q_n] = report("masked_partials", f"T={t_n} Q={q_n}", ms,
                              plain, n_bytes, n_ops, "float64", err,
                              library_ms=lib)
        records[q_n]["device_ms"] = device_ms_per_call(
            f"masked_partials Q={q_n}", lambda: fms.masked_partials(mask, meas))
        del mask
    return records


def check_k5(rel, seed):
    import torch
    from repro_torch.kernels.range_mask_agg import ops as rma
    from repro_torch.kernels.range_mask_agg.ref import range_mask_agg_ref

    log("-- K5 range_mask_agg (f32): count exact, sums/sumsq rtol 1e-5, "
        "repeat bitwise")
    rows = np.random.default_rng(seed + 8).permutation(rel.cardinality)
    blk = rel.take(rows[:SF1_BATCH_T])
    f32 = torch.float32
    x = blk.num_normalized.to(f32)
    meas = blk.measures.to(f32)
    payload = torch.cat([meas, meas * meas, meas.new_ones((len(meas), 1))], 1)
    t_n, l = x.shape
    p = payload.shape[1]
    q_n = 128
    s = _fused_snippets(rel, seed, 2000, q_n).to(rel.device)
    lo, hi = s.lo.to(f32), s.hi.to(f32)
    extra = rma.categorical_premask(blk.cat, s.cat)
    args = (x, payload, lo, hi, extra)
    got = rma.range_mask_agg(*args)
    again = rma.range_mask_agg(*args)
    want = range_mask_agg_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "K5 is not bitwise across runs"
    assert torch.equal(got[:, -1], want[:, -1]), "K5 count differs"
    assert torch.allclose(got[:, :-1], want[:, :-1], rtol=1e-5, atol=0.0), (
        float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()))
    err = float((got - want).abs().max())
    ms = time_ms(lambda: rma.range_mask_agg(*args), inner=10)
    plain = time_ms(lambda: range_mask_agg_ref(*args))
    n_bytes = 4 * (t_n * l + t_n * p + 2 * q_n * l + t_n * q_n + q_n * p)
    n_ops = t_n * q_n * (2 * l + 2 * p)
    rec = report("range_mask_agg", f"T={t_n} Q={q_n}", ms, plain, n_bytes,
                 n_ops, "float32", err)
    rec["device_ms"] = device_ms_per_call(
        "range_mask_agg Q=128", lambda: rma.range_mask_agg(*args))
    log("  library_ms is null for range_mask_agg: no single PyTorch call "
        "computes range compares times a mask folded against a payload")
    return rec


def _se_inputs(rng, n, l, equality=False):
    """Pre-widened ranges of ``n`` snippets over ``l`` dims in normalized
    units, widths 0.05-0.45; ``equality`` makes dim 0 a zero-width range
    widened to 1e-6, as ``covariance.widened`` does."""
    lo = rng.uniform(0.0, 0.6, (n, l))
    hi = lo + rng.uniform(0.05, 0.45, (n, l))
    if equality:
        hi[:, 0] = lo[:, 0] + 1e-6
    return lo, hi


def _k3_ops(n_i, n_j, l):
    """Operations of K3's forward and gradient, from the shapes. Every
    add, subtract, multiply, divide, compare, exp and erf counts as one
    operation (libdevice's exp and erf are tens of instructions each, so
    this is a lower bound on the card's work). Forward, per element and
    dimension: 4 antiderivatives of 9 (difference, u/z, square, exp,
    ((-z/2) z) e, ((sqrt(pi)/2) z) u, erf, its product, subtract), 3 for
    the inclusion-exclusion, clamp and product: 41; per element 3 more for
    the sigma2 and norm scale. Gradient, per element and dimension: 4
    antiderivatives of 13 (the 9 and dF/dz's 4), 6 for the two
    inclusion-exclusions, clamp and its mask: 60; per element 3 for the
    scale, l^2 for the products over the other dims, l for the block
    reduction."""
    fwd = n_i * n_j * (41 * l + 3)
    grad = n_i * n_j * (60 * l + 3 + l * l + l)
    return fwd, grad


def check_k3(seed, dev):
    import torch
    from repro_torch.kernels.se_covariance import ops as se
    from repro_torch.kernels.se_covariance.ref import (se_cov_grad_ref,
                                                       se_cov_matrix_ref,
                                                       se_double_integral)

    log("-- K3 se_cov_matrix (forward): against the plain version on the "
        "card, f64 rtol 1e-12 on ranges wider than 0.05 and rtol 1e-3 on "
        "equality ranges, f32 rtol 2e-5 atol 1e-7 (the reference's f32 "
        "budget); repeat bitwise; f64 bitwise equal to the plain version's "
        "per-dimension integrals multiplied in the kernel's order")
    log("-- K3 se_cov_grad (gradient wrt ls): against torch.autograd.grad of "
        "the plain version on the card, f64 rtol 1e-9 (another summation "
        "order over n_i*n_j terms); repeat bitwise")
    l = 3
    records = {}
    rng = np.random.default_rng(seed + 13)
    ls = torch.as_tensor(rng.uniform(0.3, 1.5, l), device=dev)
    sigma2 = 1.7
    for n_i, n_j in ((128, SYNOPSIS_C), (SYNOPSIS_C, SYNOPSIS_C)):
        lo_i, hi_i = _se_inputs(rng, n_i, l)
        lo_j, hi_j = _se_inputs(rng, n_j, l)
        norm_i, norm_j = rng.uniform(0.5, 2.0, n_i), rng.uniform(0.5, 2.0, n_j)
        f64 = [torch.as_tensor(v, device=dev) for v in
               (lo_i, hi_i, lo_j, hi_j)]
        ni_t = torch.as_tensor(norm_i, device=dev)
        nj_t = torch.as_tensor(norm_j, device=dev)
        want64 = se_cov_matrix_ref(*f64, ls, sigma2, ni_t, nj_t)
        fwd_ops, grad_ops = _k3_ops(n_i, n_j, l)
        for dt, rtol, atol in ((torch.float64, 1e-12, 0.0),
                               (torch.float32, 2e-5, 1e-7)):
            args = [t.to(dt) for t in (*f64, ls)] + [sigma2] + [
                t.to(dt) for t in (ni_t, nj_t)]
            got = se.se_cov_matrix(*args)
            again = se.se_cov_matrix(*args)
            want = se_cov_matrix_ref(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again), "K3 is not bitwise across runs"
            assert bool(torch.isfinite(got).all())
            assert torch.allclose(got, want, rtol=rtol, atol=atol), (
                dt, float(((got - want).abs() / want.abs()).max()))
            err = float((got - want).abs().max())
            name = str(dt).replace("torch.", "")
            # The plain version's clamped per-dimension integrals, multiplied
            # in the kernel's order ((g0 g1) g2) and scaled as it scales.
            g = torch.clamp(se_double_integral(
                args[0][:, None, :], args[1][:, None, :], args[2][None],
                args[3][None], args[4]), min=0.0)
            seq = g[..., 0]
            for k in range(1, l):
                seq = seq * g[..., k]
            seq = sigma2 * seq / (args[6][:, None] * args[7][None, :])
            same_seq = bool(torch.equal(got, seq))
            if dt == torch.float64:
                assert same_seq, "K3 f64 differs from the plain version's " \
                    "per-dimension integrals multiplied in its order"
            log(f"  se_cov_matrix {n_i}x{n_j} {name}: bitwise equal to the "
                f"plain version on the card: {bool(torch.equal(got, want))} "
                f"({int((got != want).sum())} of {got.numel()} differ); "
                "to its per-dimension integrals multiplied in the kernel's "
                f"order: {same_seq}; largest relative difference "
                f"{float(((got - want).abs() / want.abs().clamp(min=1e-300)).max()):.3e}; "
                f"against the f64 plain version "
                f"{float(((got.double() - want64).abs() / want64.abs()).max()):.3e}")
            del g, seq
            ms = time_ms(lambda: se.se_cov_matrix(*args), inner=10)
            plain = time_ms(lambda: se_cov_matrix_ref(*args), reps=10)
            size = 8 if dt == torch.float64 else 4
            n_bytes = size * (2 * (n_i + n_j) * l + l + n_i + n_j + 1
                              + n_i * n_j)
            records[(n_i, name)] = report(
                "se_cov_matrix", f"{n_i}x{n_j} l={l} {name}", ms, plain,
                n_bytes, fwd_ops,
                "float64_simt" if dt == torch.float64 else "float32", err)
            records[(n_i, name)]["device_ms"] = device_ms_per_call(
                f"se_cov_matrix {n_i}x{n_j} {name}",
                lambda: se.se_cov_matrix(*args))
        # Equality ranges: 1e-6 wide dim 0, ~12 digits cancel (f64 only).
        eq_i = [torch.as_tensor(v, device=dev)
                for v in _se_inputs(rng, n_i, l, equality=True)]
        eq = (*eq_i, *f64[2:], ls, sigma2, ni_t, nj_t)
        got, want = se.se_cov_matrix(*eq), se_cov_matrix_ref(*eq)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=1e-3, atol=0.0)
        log(f"  equality ranges {n_i}x{n_j} f64: largest relative "
            f"difference {float(((got - want).abs() / want.abs().clamp(min=1e-300)).max()):.3e}"
            f", bitwise {bool(torch.equal(got, want))}")
        if n_i != n_j:
            continue
        # The gradient at the rebuild shape.
        g_out = torch.as_tensor(rng.normal(size=(n_i, n_j)), device=dev)
        gargs = (*f64, ls, sigma2, ni_t, nj_t, g_out)
        got = se.se_cov_grad(*gargs)
        again = se.se_cov_grad(*gargs)
        want = se_cov_grad_ref(*gargs)
        # And through autograd: the Function's backward is the same kernel.
        z = ls.clone().requires_grad_(True)
        (via,) = torch.autograd.grad(
            se.se_cov_matrix(*f64, z, sigma2, ni_t, nj_t), z, g_out)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "K3 gradient is not bitwise across runs"
        assert torch.equal(got, via), "autograd did not run the gradient kernel"
        assert torch.allclose(got, want, rtol=1e-9, atol=0.0), (got, want)
        err = float((got - want).abs().max())
        log(f"  se_cov_grad {n_i}x{n_j} f64: {got.tolist()} against "
            f"{want.tolist()}, largest relative difference "
            f"{float(((got - want).abs() / want.abs()).max()):.3e}")
        ms = time_ms(lambda: se.se_cov_grad(*gargs), inner=10)
        plain = time_ms(lambda: se_cov_grad_ref(*gargs), reps=10)
        n_bytes = 8 * (2 * (n_i + n_j) * l + l + n_i + n_j + 1 + n_i * n_j
                       + l)
        records["grad"] = report("se_cov_grad", f"{n_i}x{n_j} l={l} float64",
                                 ms, plain, n_bytes, grad_ops, "float64_simt",
                                 err)
        records["grad"]["device_ms"] = device_ms_per_call(
            f"se_cov_grad {n_i}x{n_j} float64", lambda: se.se_cov_grad(*gargs))
    log("  library_ms is null for both: no single PyTorch call computes the "
        "SE double-integral product or its lengthscale gradient")
    return records


# ------------------------------------------------------------------ phase 3
def _snippet_keys_per_agg(results):
    from repro_torch.core.store import group_rows
    from repro_torch.core.types import snippet_key

    keys = {}
    for r in results:
        if r.plan is None:
            continue
        lo, hi, cat, agg, mea = r.plan.snippets.numpy()
        for key, rows in group_rows(r.plan.snippets):
            keys.setdefault(key, set()).update(
                snippet_key(lo[i], hi[i], cat[i], agg[i], mea[i])
                for i in rows)
    return {k: len(v) for k, v in keys.items()}


def _stage_timers(eng):
    """Wrap the engine's stages with device-synchronised host timers."""
    import torch
    from repro_torch.core.synopsis import Synopsis

    acc = {"scan": 0.0, "improve": 0.0, "record": 0.0, "ingest": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            return out
        return run

    eng.scan.eval_block = timed("scan", eng.scan.eval_block)
    eng.store.improve_groups = timed("improve", eng.store.improve_groups)
    eng.store.record = timed("record", eng.store.record)
    orig_apply = Synopsis._apply_add
    Synopsis._apply_add = timed("ingest", orig_apply)

    def restore():  # the timers wrap instance attributes: drop them
        del eng.scan.eval_block, eng.store.improve_groups, eng.store.record
        Synopsis._apply_add = orig_apply

    return acc, restore


def _assert_healthy(eng):
    """Every synopsis learns: none was quarantined by a failed ingest."""
    stats = eng.ingest_stats()
    log("  ingest: " + "; ".join(
        f"{k} high_water {v['high_water']} shed {v['shed_count']}"
        for k, v in stats.items()))
    sick = {k: v["quarantine_reason"] for k, v in stats.items()
            if v["quarantined"]}
    assert not sick, f"quarantined synopses on the main path: {sick}"


def _serve(eng, queries, target=0.02):
    """Serve ``queries`` one by one at ``target``; returns the results, the
    latencies (ms, host clock around a synchronised call), each query's
    ``batches_used`` and the wall time (s)."""
    import torch

    lat, used, results = [], [], []
    t0 = time.perf_counter()
    for q in queries:
        t = time.perf_counter()
        r = eng.execute(q, target_rel_error=target)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        used.append(r.batches_used)
        results.append(r)
    return results, np.asarray(lat) * 1e3, used, time.perf_counter() - t0


def _coverage(rel, results):
    """Right answers: finite cells close to the exact answers over all rows,
    which come from a plain PyTorch scan (``Relation.exact_answer``), not
    from K1. Returns (cells inside their 95% interval, cells, median
    relative error)."""
    import torch
    from repro_torch.aqp import queries as Q
    from repro_torch.utils.stats import confidence_multiplier

    alpha = float(confidence_multiplier(0.95))
    covered, rel_err = 0, []
    for r in results:
        if r.plan is None:  # a group-by that found no groups: no cells
            continue
        exact = rel.exact_answer(r.plan.snippets)
        cells = Q.assemble_results(r.plan, exact, torch.zeros_like(exact),
                                   rel.cardinality)
        for c, e in zip(r.cells, cells):
            assert np.isfinite(c["estimate"]) and np.isfinite(c["beta2"])
            err = abs(c["estimate"] - e["estimate"])
            rel_err.append(err / max(abs(e["estimate"]), 1e-300))
            covered += err <= alpha * np.sqrt(c["beta2"])
    med = float(np.median(rel_err))
    log(f"against exact answers over all {rel.cardinality} rows (plain "
        f"scan): median relative error {med:.4e}, max {max(rel_err):.4e}, "
        f"95% intervals cover {covered}/{len(rel_err)} cells")
    return int(covered), len(rel_err), med


def main_path(seed):
    import torch
    from repro_torch.aqp.workload import tpch_like, tpch_workload
    from repro_torch.core.engine import EngineConfig, VerdictEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    log("== phase 3: main path, TPC-H SF1 lineitem cardinality")
    n_rows = 6_001_215
    t0 = time.perf_counter()
    rel = tpch_like(seed, n_rows=n_rows)
    cfg = EngineConfig(sample_rate=0.1, n_batches=10, capacity=2000,
                       seed=seed)
    eng = VerdictEngine(rel, cfg)
    torch.cuda.synchronize()
    log(f"data + sample: {n_rows} rows, {eng.batches.relation.cardinality} "
        f"sample tuples in {eng.batches.n_batches} batches of "
        f"~{len(eng.batches.batch_rows[0])} on {rel.device}, "
        f"{time.perf_counter() - t0:.2f} s (set-up); scale cut: none")
    warm = tpch_workload(seed, rel.schema, 2000)
    reset_launch_counts()
    t0 = time.perf_counter()
    warm_res = eng.execute_many(warm)
    eng.drain()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_counts = launch_counts()
    distinct = _snippet_keys_per_agg(warm_res)
    log(f"warm-up: {len(warm_res)} queries in {warm_s:.3f} s, "
        f"launches {warm_counts}")
    evicted = []
    for key, syn in sorted(eng.store.items()):
        log(f"  key {key}: fill {syn.n}/{syn.capacity}, distinct snippets "
            f"recorded {distinct.get(key, 0)}")
        if syn.n == syn.capacity and distinct.get(key, 0) > syn.capacity:
            evicted.append(key)
    assert evicted, "no aggregate key reached capacity and evicted"
    _assert_healthy(eng)

    serve = tpch_workload(seed + 1, rel.schema, 200)
    reset_launch_counts()
    results, lat_ms, used, serve_s = _serve(eng, serve)
    counts = launch_counts()
    log(f"serve: 200 queries in {serve_s:.3f} s = {200 / serve_s:.2f} q/s, "
        f"p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p99 {np.percentile(lat_ms, 99):.3f} ms, "
        f"mean batches_used {np.mean(used):.3f}, launches {counts}")
    assert counts["fused_masked_scan"] > 0 and counts["gp_batch_infer"] > 0, (
        counts)
    # Every covariance build (ingest, improve) runs K3's forward.
    assert counts["se_cov_matrix"] > 0 and counts["se_cov_grad"] == 0, counts
    eng.drain()
    _assert_healthy(eng)
    covered, n_cells, med = _coverage(rel, results)
    assert med <= 0.02, med

    # Where the time goes: 50 more queries with synchronised stage timers.
    acc, restore = _stage_timers(eng)
    more = tpch_workload(seed + 4, rel.schema, 50)
    t0 = time.perf_counter()
    for q in more:
        eng.execute(q, target_rel_error=0.02)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    restore()
    host = wall - acc["scan"] - acc["improve"] - acc["record"]
    log("time split over 50 queries (wall %.3f s): " % wall + ", ".join(
        f"{k} {v:.3f} s ({100 * v / wall:.1f}%)" for k, v in acc.items())
        + f", host/plan/other {host:.3f} s ({100 * host / wall:.1f}%)"
        " [ingest runs on its own thread; improve waits for it]")

    # Device busy share: 20 more queries under the profiler.
    window = tpch_workload(seed + 5, rel.schema, 20)

    def serve_window():
        for q in window:
            eng.execute(q, target_rel_error=0.02)
        eng.drain()

    wall, busy, per = device_profile(serve_window)
    if per:
        log(f"profiler window, 20 queries: wall {wall:.4f} s, device busy "
            f"{busy:.4f} s, idle share {1 - busy / wall:.4f}; by device time:")
        for k, v in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
            log(f"  {v[1]:.6f} s x{v[0]} {_short(k)}")
    else:
        log("profiler window: no device activity recorded (idle share not "
            "measured)")
    return counts, {"qps": 200 / serve_s,
                    "p50_ms": float(np.percentile(lat_ms, 50)),
                    "p99_ms": float(np.percentile(lat_ms, 99)),
                    "batches_used": float(np.mean(used)),
                    "covered": covered, "cells": n_cells}, rel, cfg, eng


# ------------------------------------------------------------------ phase 6
REFIT_STEPS = 150  # VerdictEngine.refit's defaults (steps=150, lr=0.1)


def _spy_fits(fits):
    """Record every ``learning.fit`` of a refit: n, the loss history, the
    fitted params and the wall time (s, synchronised). Returns the undo."""
    import torch
    from repro_torch.core import learning

    orig = learning.fit

    def fit(snippets, theta, beta2, schema, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, hist = orig(snippets, theta, beta2, schema, **kw)
        torch.cuda.synchronize()
        fits.append(dict(n=int(theta.shape[0]), hist=hist.numpy(),
                         params=params, s=time.perf_counter() - t))
        return params, hist

    learning.fit = fit
    return lambda: setattr(learning, "fit", orig)


def _params_of(store):
    from repro_torch.core.types import to_numpy

    return {k: [to_numpy(t) for t in (s.params.log_ls, s.params.log_sigma2,
                                      s.params.mu)]
            for k, s in sorted(store.items())}


def learning_and_checkpoints(eng, rel, cfg, seed, e2e3):
    """Phase 6 on phase 3's engine: refit with the defaults, checkpoint and
    restore into a fresh engine (bitwise), serve fresh queries after the
    refit, then a drifted data append on every synopsis."""
    import tempfile

    import torch
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.core.append import estimate_append_stats
    from repro_torch.core.engine import VerdictEngine
    from repro_torch.core.types import AVG, to_numpy
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.kernels import launch_counts, reset_launch_counts

    log(f"== phase 6: learning and checkpoints on phase 3's engine, "
        f"{rel.cardinality} rows, capacity {cfg.capacity}")
    # 1. refit with the defaults.
    eng.drain()
    keys = [k for k, syn in eng.store.items()
            if syn.n >= 3 and not syn.quarantined]
    fits = []
    undo = _spy_fits(fits)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        eng.refit()
        torch.cuda.synchronize()
    finally:
        undo()
    refit_s = time.perf_counter() - t0
    counts = launch_counts()
    assert len(fits) == len(keys) > 0, (len(fits), keys)
    finite_steps = 0
    for key, f in zip(keys, fits):
        h, p = f["hist"], f["params"]
        finite_steps += int(np.isfinite(h).sum())
        log(f"  refit {key}: n {f['n']}, NLL {h[0]:.6f} -> {h[-1]:.6f} "
            f"({int(np.isfinite(h).sum())} of {len(h)} steps finite), "
            f"lengthscales {np.exp(to_numpy(p.log_ls)).tolist()}, "
            f"sigma2 {float(p.sigma2):.6e}, mu {float(p.mu):.6e}, "
            f"{f['s']:.3f} s ({1e3 * f['s'] / len(h):.3f} ms per step)")
        assert h[-1] < h[0], (key, h[0], h[-1])
        assert all(bool(torch.isfinite(t).all()) for t in (
            p.log_ls, p.log_sigma2, p.mu)), key
    _assert_healthy(eng)
    log(f"refit: {len(fits)} synopses in {refit_s:.3f} s, launches {counts}"
        f", {finite_steps} finite steps")
    assert counts["se_cov_matrix"] >= REFIT_STEPS * len(fits), counts
    assert counts["se_cov_grad"] >= REFIT_STEPS * len(fits), counts

    # 2. Checkpoint right after the refit (a refit ends in a full rebuild,
    # which is what a restore computes), restore into a fresh engine, and
    # serve 20 queries through both in lockstep.
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        eng.save_synopses(mgr, step=1)
        save_s = time.perf_counter() - t0
        fresh = VerdictEngine(rel, cfg)
        t0 = time.perf_counter()
        extra = fresh.load_synopses(mgr)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
    assert extra == {"kind": "verdict-synopses"}, extra
    want, got = eng.synopses_state_dict(), fresh.synopses_state_dict()
    assert want.keys() == got.keys()
    for name in want:
        assert want[name].keys() == got[name].keys()
        for k in want[name]:
            assert np.array_equal(want[name][k], got[name][k]), (name, k)
    lockstep = tpch_workload(seed + 12, rel.schema, 20)
    for i, q in enumerate(lockstep):
        a = eng.execute(q, target_rel_error=0.02)
        b = fresh.execute(q, target_rel_error=0.02)
        assert a.batches_used == b.batches_used and a.cells == b.cells, (
            f"restored engine differs on lockstep query {i}")
    fresh.drain()
    _assert_healthy(fresh)
    log(f"checkpoint: saved in {save_s:.3f} s ({size} bytes), restored into "
        f"a fresh engine in {load_s:.3f} s; every state_dict array bitwise "
        f"equal; 20 lockstep queries bitwise equal (cells, batches_used)")
    del fresh

    # 3. Serve 200 fresh queries after the refit.
    results, lat_ms, used, serve_s = _serve(
        eng, tpch_workload(seed + 11, rel.schema, 200))
    eng.drain()
    _assert_healthy(eng)
    covered, n_cells, med = _coverage(rel, results)
    e2e = {"qps": 200 / serve_s, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "batches_used": float(np.mean(used)), "covered": covered,
           "cells": n_cells, "refit_s": refit_s}
    log(f"serve after refit: 200 fresh queries {e2e['qps']:.2f} q/s, p50 "
        f"{e2e['p50_ms']:.3f} ms, p99 {e2e['p99_ms']:.3f} ms, mean "
        f"batches_used {e2e['batches_used']:.3f}, coverage {covered}/"
        f"{n_cells}; phase 3 before the refit: {e2e3['qps']:.2f} q/s, p50 "
        f"{e2e3['p50_ms']:.3f} ms, p99 {e2e3['p99_ms']:.3f} ms, mean "
        f"batches_used {e2e3['batches_used']:.3f}, coverage "
        f"{e2e3['covered']}/{e2e3['cells']}")

    # 4. A drifted append: 20% new rows, measures shifted by +0.8.
    n_new = rel.cardinality // 5
    new = rel.take(np.arange(n_new))
    new.measures = new.measures + 0.8
    stats = estimate_append_stats(rel.measures[:500], new.measures[:500],
                                  rel.cardinality, n_new)
    log(f"append: {n_new} rows, mu {stats.mu.tolist()}, eta2 "
        f"{stats.eta2.tolist()}, f {stats.frac:.6f}")
    grown = 0
    for key, syn in sorted(eng.store.items()):
        sd = syn.state_dict()
        b2_before, th_before = to_numpy(syn.beta2()), to_numpy(syn.theta())
        syn.apply_append(stats)
        b2_after, th_after = to_numpy(syn.beta2()), to_numpy(syn.theta())
        assert np.all(b2_after >= b2_before), key  # beta^2 only grows
        avg = sd["agg"] == AVG
        shift = stats.frac * stats.mu[sd["measure"]]
        assert np.array_equal(th_after[avg], th_before[avg] + shift[avg]), key
        assert np.array_equal(th_after[~avg], th_before[~avg]), key
        grown += int((b2_after > b2_before).sum())
    _assert_healthy(eng)
    log(f"append applied to {len(eng.store)} synopses: beta^2 grew on "
        f"{grown} rows and fell on none; every AVG theta moved by f*mu_k, "
        "every FREQ theta unchanged")
    return counts, e2e


# ------------------------------------------------------------------ phase 5
N_SHARDS = 4  # logical shards of the mesh on one card


def _spy(obj, name, sink, fn):
    """Wrap ``obj.<name>`` so that each call's ``fn(args, out)`` goes into
    ``sink``; the wrapped method's result is returned unchanged."""
    orig = getattr(obj, name)

    def run(*a, **kw):
        out = orig(*a, **kw)
        sink.append(fn(a, out))
        return out

    setattr(obj, name, run)


def _drive_session(sess, warm, serve, tail, budget):
    """One session's run of phase 5: the warm-up through ``execute_many``,
    ``serve`` one by one through ``execute`` (timed), then ``tail``, a list
    of ``(query, streamed)``, through ``stream`` or ``execute``. Returns the
    answers in order (a stream's last one), the latencies (s), and what the
    spies saw: each improve's ``accepted`` and each scanned block's tuple
    count."""
    import torch
    from repro_torch.core.types import to_numpy

    accepted, blocks = [], []
    _spy(sess.store, "improve_groups", accepted,
         lambda a, out: to_numpy(out.accepted))
    _spy(sess.engine.scan, "eval_block", blocks,
         lambda a, out: int(a[0].num_normalized.shape[0]))
    answers = list(sess.execute_many(warm))
    lat = []
    for q in serve:
        t = time.perf_counter()
        answers.append(sess.execute(q, budget))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    for q, streamed in tail:
        if not streamed:
            answers.append(sess.execute(q, budget))
            continue
        parts = list(sess.stream(q, budget))
        assert [p.final for p in parts] == [False] * (len(parts) - 1) + [
            True], "stream: only the last answer is final"
        assert len(parts) == parts[-1].batches_used
        answers.append(parts[-1])
    sess.drain()
    return answers, lat, accepted, blocks


def _same_answer(a, b):
    return (a.batches_used == b.batches_used
            and a.tuples_scanned == b.tuples_scanned
            and [(c.estimate, c.beta2) for c in a.cells]
            == [(c.estimate, c.beta2) for c in b.cells])


def facade_and_mesh(rel, cfg, seed):
    """Phase 5: ``connect`` with and without a mesh at SF1, answers bitwise
    equal, the mesh scanning through K4 once per round."""
    import torch
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.verdict import ErrorBudget, Mesh, connect

    log(f"== phase 5: the connect/Session facade, local and over a "
        f"{N_SHARDS}-shard mesh on one card, {rel.cardinality} rows")
    budget = ErrorBudget(target_rel_error=0.02)
    warm = tpch_workload(seed + 6, rel.schema, 200)
    serve = tpch_workload(seed + 7, rel.schema, 50)
    extra = tpch_workload(seed + 8, rel.schema, 6)
    mesh = Mesh((rel.device,) * N_SHARDS)
    runs, e2e = {}, {}
    for name, kw in (("local", {}), ("mesh", {"mesh": mesh})):
        sess = connect(rel, cfg, **kw)
        rep = sess.explain(serve[0])
        log(f"{name}: explain scan={rep.scan_placement} "
            f"evaluator={rep.scan_evaluator}")
        # The local session streams the first three extra queries and
        # executes the last three, the mesh session the other way round:
        # each stream's last answer then meets the other session's execute
        # of the same query on the same state.
        tail = [(q, (i < 3) == (name == "local")) for i, q in
                enumerate(extra)]
        reset_launch_counts()
        t0 = time.perf_counter()
        answers, lat, accepted, blocks = _drive_session(
            sess, warm, serve, tail, budget)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = launch_counts()
        lat_ms = np.asarray(lat) * 1e3
        e2e[name] = {"qps": len(lat) / float(np.sum(lat)),
                     "p50_ms": float(np.percentile(lat_ms, 50)),
                     "p99_ms": float(np.percentile(lat_ms, 99))}
        log(f"{name}: {took:.3f} s in all; serve {len(lat)} queries "
            f"{e2e[name]['qps']:.2f} q/s, p50 {e2e[name]['p50_ms']:.3f} ms, "
            f"p99 {e2e[name]['p99_ms']:.3f} ms; launches {counts}")
        st = sess.stats()
        assert not st["health"]["quarantined"], st["health"]["quarantined"]
        _assert_healthy(sess.engine)
        runs[name] = dict(answers=answers, accepted=accepted, blocks=blocks,
                          counts=counts, stats=st, explain=rep, sess=sess)
    loc, msh = runs["local"], runs["mesh"]
    # Bitwise: every answer (cells, batches_used) and every improve's
    # accepted mask of the mesh session equal the local session's; the
    # three streams of each session end on the other's execute.
    assert len(loc["answers"]) == len(msh["answers"])
    diff = [i for i, (a, b) in enumerate(zip(loc["answers"], msh["answers"]))
            if not _same_answer(a, b)]
    assert not diff, f"mesh answers differ from local on queries {diff[:10]}"
    assert len(loc["accepted"]) == len(msh["accepted"]) and all(
        np.array_equal(a, b) for a, b in zip(loc["accepted"],
                                             msh["accepted"])), "accepted"
    # The mesh scanned through K4 once per round, never through K1.
    st = msh["stats"]["scan"]
    rounds = len(msh["blocks"])
    assert st["blocks_evaluated"] == rounds > 0
    assert msh["counts"]["masked_partials"] == rounds, (msh["counts"], rounds)
    assert msh["counts"]["fused_masked_scan"] == 0, msh["counts"]
    assert msh["counts"]["gp_batch_infer"] > 0, msh["counts"]
    assert loc["counts"]["fused_masked_scan"] == len(loc["blocks"]) > 0
    assert loc["counts"]["masked_partials"] == 0, loc["counts"]
    # Each block pads to the next power of two (65,536 for an SF1 batch of
    # ~60,013 tuples), which 4 divides.
    pad = sum((1 << (t - 1).bit_length()) - t for t in msh["blocks"])
    assert (st["kind"], st["n_shards"], st["pad_rows"], st["tuples_scanned"]
            ) == ("sharded", N_SHARDS, pad, sum(msh["blocks"])), st
    assert st["evaluator"] == "sharded_mask+kernel_agg", st
    rep = msh["explain"]
    assert rep.scan_placement == f"sharded:{N_SHARDS}xdata", rep
    assert rep.scan_evaluator == "sharded_mask+kernel_agg", rep
    assert loc["explain"].scan_placement == "local"
    assert loc["explain"].scan_evaluator == "fused_masked_scan"
    store = msh["stats"]["store"]
    log(f"mesh: {rounds} rounds, K4 launches {msh['counts']['masked_partials']}"
        f", pad_rows {st['pad_rows']}, tuples_scanned {st['tuples_scanned']}; "
        "store shards " + ", ".join(f"{sh['n_keys']} keys/{sh['fill']} rows"
                                    for sh in store["shards"]))
    log(f"mesh answers bitwise equal to local on all {len(loc['answers'])}"
        f" queries (cells, batches_used; accepted of {len(loc['accepted'])} "
        "improves); each stream ended on the other session's execute")
    _refit_sessions(runs, rel, seed, budget)
    e2e["round_ms"] = _scan_round_ms(rel, seed, mesh)
    return msh["counts"], e2e


def _refit_sessions(runs, rel, seed, budget):
    """``Session.refit()`` on the local and the mesh session alike, then 20
    more queries each: the mesh session's learned params and answers must be
    bitwise the local one's (placement moves work, never values)."""
    import torch
    from repro_torch.aqp.workload import tpch_workload

    post = tpch_workload(seed + 13, rel.schema, 20)
    for name in ("local", "mesh"):
        sess = runs[name]["sess"]
        t0 = time.perf_counter()
        sess.refit()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        runs[name]["params"] = _params_of(sess.store)
        runs[name]["post"] = [sess.execute(q, budget) for q in post]
        sess.drain()
        _assert_healthy(sess.engine)
        log(f"{name}: refit of {len(sess.store)} synopses (fill "
            f"{[syn.n for _, syn in sorted(sess.store.items())]}) in "
            f"{took:.3f} s")
    loc, msh = runs["local"], runs["mesh"]
    assert loc["params"].keys() == msh["params"].keys()
    for key in loc["params"]:
        assert all(np.array_equal(a, b) for a, b in zip(
            loc["params"][key], msh["params"][key])), key
    diff = [i for i, (a, b) in enumerate(zip(loc["post"], msh["post"]))
            if not _same_answer(a, b)]
    assert not diff, f"after refit, mesh answers differ on queries {diff}"
    log("after Session.refit: learned params and the next 20 answers of the "
        "mesh session bitwise equal to the local session's")


def _scan_round_ms(rel, seed, mesh):
    """Where the mesh's extra time goes: one scan round of a sample batch at
    the serving shape (one tile of 128 snippets), locally (K1), over the
    mesh (mask build, gather, K4), and the mesh's mask stage alone. Host
    clock around a synchronised call, median of 20, in ms."""
    import torch
    from repro_torch.aqp.executor import (ScanPlacement,
                                          ShardedScanPlacement,
                                          sharded_mask)
    from repro_torch.kernels import launch_counts

    rows = np.random.default_rng(seed + 10).permutation(rel.cardinality)
    blk = rel.take(rows[:SF1_BATCH_T])
    s = _fused_snippets(rel, seed, 2000, 128).to(rel.device)
    local, sharded = ScanPlacement(), ShardedScanPlacement(mesh)
    # With no evaluator given, the local placement runs K1 on the card.
    before = launch_counts()["fused_masked_scan"]
    local.eval_block(blk, s)
    assert launch_counts()["fused_masked_scan"] == before + 1
    assert local.stats()["evaluator"] == "fused_masked_scan"
    runs = {
        "local": lambda: local.eval_block(blk, s),
        "mesh": lambda: sharded.eval_block(blk, s),
        "mesh_mask_stage": lambda: sharded_mask(
            mesh, blk.num_normalized, blk.cat, s),
    }
    out = {}
    for name, fn in runs.items():
        for _ in range(3):
            fn()
        ts = []
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        out[name] = float(np.median(ts)) * 1e3
    log("one scan round, T=%d Q=128 (host clock, synchronised, median of "
        "20): " % SF1_BATCH_T + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in out.items()))
    return out


def k5_on_the_scan_placement(rel, cfg, seed):
    """K5 through ``ScanPlacement.eval_block(local_eval=
    eval_partials_kernel)`` over every SF1 sample batch for one fused
    workload, against K1 on the same blocks.

    K5 compares in float32, as the reference kernel does; K1 in float64. A
    tuple less than a float32 ulp outside a bound is therefore inside for
    K5 and outside for K1 (the reference's own K5 does the same against its
    float64 scan). Those boundary tuples are found in plain PyTorch, from
    the two compares, and K1's partials are corrected by exactly them: the
    counts must then be equal, and the sums and sums of squares within the
    reference's budget (rtol 2e-4)."""
    import torch
    from repro_torch.aqp.executor import (ScanPlacement, payload_of,
                                          predicate_mask)
    from repro_torch.aqp.plan import plan_workload
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.core.types import pad_snippets
    from repro_torch.kernels import RANGE_EPS, launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_masked_scan.ops import eval_partials_fused
    from repro_torch.kernels.range_mask_agg.ops import (categorical_premask,
                                                        eval_partials_kernel)
    from repro_torch.verdict import connect

    log("-- K5 on the scan placement: every SF1 sample batch against K1 "
        "corrected by the float32 boundary tuples; counts equal, sums/sumsq "
        "rtol 2e-4")
    eng = connect(rel, cfg).engine
    padded = pad_snippets(plan_workload(
        eng, tpch_workload(seed + 9, rel.schema, 200)).fused).to(rel.device)
    batches = eng.batches
    blocks = [batches.relation.take(r) for r in batches.batch_rows]
    place = ScanPlacement()
    reset_launch_counts()
    got = [place.eval_block(b, padded, local_eval=eval_partials_kernel)
           for b in blocks]
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["range_mask_agg"] == len(blocks), counts
    assert place.stats()["evaluator"] == "range_mask_agg"
    f32 = torch.float32
    eps32 = torch.tensor(RANGE_EPS, dtype=f32, device=rel.device)
    lo32, hi32 = padded.lo.to(f32), padded.hi.to(f32)
    worst, flips, flipped = 0.0, 0, set()
    idx = padded.measure.long()[:, None]
    m = blocks[0].measures.shape[1]
    for bi, (b, g) in enumerate(zip(blocks, got)):
        want = eval_partials_fused(b.num_normalized, b.cat, b.measures,
                                   padded)
        x32 = b.num_normalized.to(f32)
        in32 = ((x32[:, None, :] >= (lo32 - eps32)[None])
                & (x32[:, None, :] <= (hi32 + eps32)[None])).all(-1)
        diff = (in32.to(torch.float64)
                * categorical_premask(b.cat, padded.cat).to(torch.float64)
                - predicate_mask(b.num_normalized, b.cat, padded))
        flips += int(diff.abs().sum())
        flipped.update((bi, int(q)) for q in torch.nonzero(
            diff.abs().sum(0)).flatten())
        corr = diff.T @ payload_of(b.measures)  # (Q, 2M+1), exact 0/±1 mask
        assert torch.equal(g.count, want.count + corr[:, 2 * m]), (
            "K5 count differs from K1's corrected by the boundary tuples")
        assert torch.equal(g.scanned, want.scanned)
        for f, cols in (("sums", corr[:, :m]), ("sumsq", corr[:, m:2 * m])):
            a = getattr(g, f)
            w = getattr(want, f) + cols.gather(1, idx)[:, 0]
            assert torch.allclose(a, w, rtol=2e-4, atol=0.0), f
            worst = max(worst, float(((a - w).abs() / w.abs().clamp(
                min=1e-300)).max()))
    log(f"  {len(blocks)} batches x {padded.n} snippets: {flips} "
        f"(tuple, snippet) pairs inside a bound in float32 and outside in "
        f"float64, on (batch, snippet) {sorted(flipped)}; counts equal K1's "
        f"corrected by them; largest relative difference of sums/sumsq "
        f"{worst:.3e}; launches {counts}")
    return counts["range_mask_agg"]


# ------------------------------------------------------------------ phase 4
def _decisions(a, b, i, cfg, target, d):
    """Compare the decisions of query ``i`` in two engines, each read from
    its input, relative to the input's own scale: the stop test reads the
    largest relative error (against ``target``), validation reads the model
    answer theta (against ``|raw - theta| = t``, and for FREQ ``theta >=
    0``; scale ``max(|theta|, |raw|)``). Where both engines agree, the
    difference of the input goes into ``d["stop"]`` / ``d["theta"]``; where
    they differ, (query, what, a's, b's, the distance of the input from its
    threshold) goes into ``d["flips"]``."""
    from repro_torch.core.types import FREQ
    from repro_torch.utils.stats import confidence_multiplier

    e_a, e_b = (r.max_rel_error(cfg.report_delta) for r in (a, b))
    if a.batches_used != b.batches_used:
        e = e_a if a.batches_used < b.batches_used else e_b  # it stopped
        d["flips"].append((i, "batches_used", a.batches_used, b.batches_used,
                           abs(e - target) / target))
        return
    d["stop"] = max(d["stop"], abs(e_a - e_b) / max(e_b, 1e-300))
    if a.snippet_answer is None:
        return
    sa, sb = a.snippet_answer, b.snippet_answer
    acc_a, acc_b = sa.accepted.cpu().numpy(), sb.accepted.cpu().numpy()
    a_v = float(confidence_multiplier(cfg.delta_v))
    for j in range(len(acc_a)):
        raw = float(sb.raw_theta[j])
        if acc_a[j] == acc_b[j]:
            if acc_a[j]:
                d["theta"] = max(d["theta"], abs(float(sa.theta[j]) - float(
                    sb.theta[j])) / max(abs(float(sb.theta[j])), abs(raw),
                                        1e-300))
            continue
        th = float((sa if acc_a[j] else sb).theta[j])  # the model's theta
        t = a_v * float(sb.raw_beta2[j].sqrt())
        dist = abs(abs(raw - th) - t)
        if int(a.plan.snippets.agg[j]) == FREQ:
            dist = min(dist, abs(th))
        d["flips"].append((i, "accepted", int(acc_a[j]), int(acc_b[j]),
                           dist / max(abs(th), abs(raw), 1e-300)))


def _compare(ra, rb, cfg, target):
    """Two engines' answers to the same queries, in order.

    Every query's decisions are compared (``_decisions``). Cells and the
    inputs of agreed decisions are compared up to the first flipped
    decision: after it the engines record different raw answers and their
    states part. Returns the largest relative difference of the estimates
    of AVG cells (``avg``) and of the other cells (``other``), of the
    cells' beta^2 (``beta2``), of the other cells' estimates over their 95%
    half-width (``other_ci``), of the decisions' inputs (``stop``,
    ``theta``), the number of queries whose cells were compared (``n``) and
    the flips (``flips``)."""
    from repro_torch.utils.stats import confidence_multiplier

    a_r = float(confidence_multiplier(cfg.report_delta))
    d = dict(avg=0.0, other=0.0, beta2=0.0, other_ci=0.0, stop=0.0,
             theta=0.0, n=0, flips=[])
    for i, (a, b) in enumerate(zip(ra, rb)):
        if d["flips"]:  # states parted: record further flips only
            _decisions(a, b, i, cfg, target,
                       dict(d, stop=0.0, theta=0.0))  # shares d["flips"]
            continue
        _decisions(a, b, i, cfg, target, d)
        if d["flips"]:
            continue
        d["n"] += 1
        for ca, cb in zip(a.cells, b.cells):
            diff = abs(ca["estimate"] - cb["estimate"])
            rel = diff / max(abs(cb["estimate"]), 1e-300)
            d["beta2"] = max(d["beta2"], abs(ca["beta2"] - cb["beta2"])
                             / max(cb["beta2"], 1e-300))
            if ca["kind"] == "AVG":
                d["avg"] = max(d["avg"], rel)
            else:
                d["other"] = max(d["other"], rel)
                d["other_ci"] = max(d["other_ci"], diff / max(
                    a_r * np.sqrt(cb["beta2"]), 1e-300))
    return d


def _log_compare(what, d):
    log(f"{what}: cells of {d['n']} queries compared, largest relative "
        f"difference AVG {d['avg']:.3e}, COUNT/SUM {d['other']:.3e} "
        f"({d['other_ci']:.3e} of their 95% half-width), beta^2 "
        f"{d['beta2']:.3e}; decision inputs: largest relative error "
        f"{d['stop']:.3e}, model theta {d['theta']:.3e}; "
        f"{len(d['flips'])} flipped decisions")
    for i, what_, x, y, dist in d["flips"]:
        log(f"  flip: query {i} {what_} {x} vs {y}, input {dist:.3e} from "
            "its threshold (relative)")


def against_plain(seed):
    import torch
    from repro_torch.aqp.workload import tpch_like, tpch_workload
    from repro_torch.core.engine import EngineConfig, VerdictEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    log("== phase 4: CUDA engine against the CPU (plain) engine, 600,000 rows")
    cfg = EngineConfig(sample_rate=0.1, n_batches=10, capacity=2000,
                       seed=seed)
    rels = {None: tpch_like(seed, n_rows=600_000),
            "cpu": tpch_like(seed, n_rows=600_000, device="cpu")}
    warm = tpch_workload(seed + 2, rels["cpu"].schema, 200)
    test = tpch_workload(seed + 3, rels["cpu"].schema, 20)
    target = 0.02

    def run(device, threads=None):
        eng = VerdictEngine(rels[device], cfg, device=device)
        old = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.execute_many(warm)
        res = [eng.execute(q, target_rel_error=target) for q in test]
        eng.drain()
        counts, took = launch_counts(), time.perf_counter() - t0
        torch.set_num_threads(old)
        _assert_healthy(eng)
        log(f"{device or 'cuda'} engine"
            f"{f' ({threads} CPU thread)' if threads else ''}"
            f": {took:.2f} s, launches {counts}")
        return res, counts, eng

    rg, g_counts, g_eng = run(None)
    rc, c_counts, c_eng = run("cpu")
    rc1, _, _ = run("cpu", threads=1)
    assert g_counts["fused_masked_scan"] > 0 and g_counts[
        "gp_batch_infer"] > 0, g_counts
    assert all(v == 0 for v in c_counts.values()), c_counts
    # AVG cells come from the well-conditioned AVG synopses and are held at
    # rtol 1e-8. COUNT and SUM cells go through the FREQ synopsis, whose
    # Sigma is badly conditioned at this sample size (raw variances ~1e-6):
    # last-bit differences of eigh, Cholesky and matmul between any two
    # summation orders grow there, as the CPU engine against itself on one
    # thread shows. They are held to a tenth of their own 95% half-width:
    # the two devices must give the same answer as far as a user can tell.
    d = _compare(rg, rc, cfg, target)
    _log_compare("CUDA vs CPU", d)
    _log_compare("CPU on 1 thread vs CPU", _compare(rc1, rc, cfg, target))
    assert d["avg"] <= 1e-8, d["avg"]
    assert d["other_ci"] <= 0.1, d["other_ci"]
    # Decisions are compared on all queries. A flip passes only where its
    # input lay within FLIP_FACTOR times the engines' largest difference of
    # that input on the agreed decisions; it is then recorded under ROADMAP
    # Queue 3.
    allowed = {"batches_used": FLIP_FACTOR * d["stop"],
               "accepted": FLIP_FACTOR * d["theta"]}
    bad = [f for f in d["flips"] if f[4] > allowed[f[1]]]
    assert not bad, f"flips outside {allowed} of their threshold: {bad}"
    out = {"avg_rel": d["avg"], "count_sum_rel": d["other"],
           "count_sum_of_half_width": d["other_ci"], "beta2_rel": d["beta2"],
           "stop_input_rel": d["stop"], "theta_input_rel": d["theta"],
           "flips": len(d["flips"])}
    # Both engines refit with the same few steps (the CPU engine is the slow
    # side), then 20 more queries are held to the same rule.
    for eng in (g_eng, c_eng):
        t0 = time.perf_counter()
        eng.refit(steps=PHASE4_REFIT_STEPS)
        log(f"{eng.device} engine: refit(steps={PHASE4_REFIT_STEPS}) in "
            f"{time.perf_counter() - t0:.2f} s")
    g_par, c_par = _params_of(g_eng.store), _params_of(c_eng.store)
    assert g_par.keys() == c_par.keys()
    ls_rel = max(float(np.max(np.abs(np.exp(g_par[k][0]) - np.exp(c_par[k][0]))
                              / np.exp(c_par[k][0]))) for k in c_par)
    log(f"fitted lengthscales, CUDA against CPU: largest relative difference "
        f"{ls_rel:.3e}")
    test2 = tpch_workload(seed + 14, rels["cpu"].schema, 20)
    rg2 = [g_eng.execute(q, target_rel_error=target) for q in test2]
    rc2 = [c_eng.execute(q, target_rel_error=target) for q in test2]
    for eng in (g_eng, c_eng):
        eng.drain()
        _assert_healthy(eng)
    d2 = _compare(rg2, rc2, cfg, target)
    _log_compare("CUDA vs CPU after refit", d2)
    assert d2["avg"] <= 1e-8, d2["avg"]
    assert d2["other_ci"] <= 0.1, d2["other_ci"]
    allowed = {"batches_used": FLIP_FACTOR * d2["stop"],
               "accepted": FLIP_FACTOR * d2["theta"]}
    bad = [f for f in d2["flips"] if f[4] > allowed[f[1]]]
    assert not bad, f"flips outside {allowed} of their threshold: {bad}"
    out.update(refit_ls_rel=ls_rel, refit_avg_rel=d2["avg"],
               refit_count_sum_of_half_width=d2["other_ci"],
               refit_flips=len(d2["flips"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    from repro_torch.aqp.workload import tpch_like

    t_start = time.perf_counter()
    smi = phase_build()
    log("== phase 2: kernels against their plain versions")
    rel = tpch_like(args.seed, n_rows=600_000)
    k1 = check_k1(rel, args.seed)
    k2 = check_k2(args.seed, rel.device)
    k4 = check_k4(rel, args.seed)
    k5 = check_k5(rel, args.seed)
    k3 = check_k3(args.seed, rel.device)
    del rel
    if args.kernels_only:
        log(f"kernels-only run done in {time.perf_counter() - t_start:.1f} s")
        return 0
    counts, e2e, rel, cfg, eng = main_path(args.seed)
    refit_counts, e2e6 = learning_and_checkpoints(eng, rel, cfg, args.seed,
                                                  e2e)
    del eng
    mesh_counts, e2e5 = facade_and_mesh(rel, cfg, args.seed)
    k5_launches = k5_on_the_scan_placement(rel, cfg, args.seed)
    del rel
    worst = against_plain(args.seed)
    kernels = [
        dict(name="fused_masked_scan", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K1_REPLACES, launches=counts["fused_masked_scan"],
             shape="T=60000 Q=128 f64", **k1[128]),
        dict(name="gp_batch_infer", route="cuda",
             source="src/repro_torch/csrc/gp_batch_infer.cu",
             replaces=K2_REPLACES, launches=counts["gp_batch_infer"],
             shape="Q=8 C=2000 f64", **k2[(8, "float64")]),
        dict(name="masked_partials", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K4_REPLACES, launches=mesh_counts["masked_partials"],
             shape=f"T={SF1_BATCH_T} Q=128 f64", **k4[128]),
        dict(name="range_mask_agg", route="cuda",
             source="src/repro_torch/csrc/range_mask_agg.cu",
             replaces=K5_REPLACES, launches=k5_launches,
             shape=f"T={SF1_BATCH_T} Q=128 f32", **k5),
        dict(name="se_cov_matrix", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_counts["se_cov_matrix"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l=3 f64",
             **k3[(SYNOPSIS_C, "float64")]),
        dict(name="se_cov_grad", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_counts["se_cov_grad"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l=3 f64", **k3["grad"]),
    ]
    log("library_ms is null for the fused masked scan and the fused GP "
        "improve: no single PyTorch call computes either; masked_partials' "
        "is one cuBLAS DGEMM, mask.T @ [m, m^2, 1]")
    log("launches: K1, K2 in phase 3's serve stream "
        f"({counts['se_cov_matrix']} K3 forward launches there too); K4 in "
        "phase 5's mesh session; K5 over the SF1 batches; K3 forward and "
        "gradient in phase 6's refit")
    log(f"end to end: phase 3 {json.dumps(e2e)}; phase 6 {json.dumps(e2e6)}; "
        f"phase 5 {json.dumps(e2e5)};"
        f" CUDA vs CPU {json.dumps(worst)};"
        f" total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
