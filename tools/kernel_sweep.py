#!/usr/bin/env python3
"""Tiling variants of the fused-scan (K1, and its kernel for any width),
masked-partials (K4), GP-improve (K2), SE-covariance Gram (K3) and
range-mask aggregation (K5) kernels.

    python3 tools/kernel_sweep.py [k1] [k1any] [k4] [k2] [k3] [k5]
        [k1global] [k3any] [--baseline REV_OR_DIR]

Needs one NVIDIA H100 and nvcc. Each variant is the checked-in source with
some constants or lines replaced, built into its own library under
``build/kernel_sweep/`` (one nvcc per variant, all started together) and
called through its C entry point on the same inputs: K1 at T = 60,000 and
Q in {128, 4096} on a TPC-H-like block and workload snippets (the shapes
of chip_smoke.py's phase 2), K4 at T = 60,013 and Q in {128, 4096} on a
random 0/1 mask, K2 at C = 2000 and Q in {8, 128} in
float64 and float32, K3's Gram forward at n = 2000, l = 3 in float64, with
and without derivatives, K1's kernel for any width at T = 60,000, Q = 128
on a block of a 9-dimension, 9-measure relation (chip_smoke.py's phase 4
relation; two launches, over 8 measures and 1), K5 at T = 60,013, Q = 128
and P in {5, 35} on a TPC-H-like block, K1's path 3 (category sets past a
block's shared memory) at T = 60,000, Q = 128 with a dim of 30,000 values
and at T = 3,000 with one of 100,000, K3's kernels for any l at l = 12
and 9 (general 128 x 2000, Gram 2000 x 2000 with and without
derivatives, the reduction). For each it prints the CUDA-event
time (median of 20 samples of 10 back-to-back calls), the profiler's device
time per kernel, and whether the output is bitwise the checked-in source's.
With no kernel named every kernel is swept.

``--baseline`` names an earlier version of the K1, K3 and K5 sources, as a
git revision of this checkout or a directory holding
``fused_masked_scan.cu``, ``se_covariance.cu`` and ``range_mask_agg.cu``:
the k1any, k1global, k3any and k5 sweeps then also check once that the
checked-in kernels give that version's bits and time it (its K5 launched
as its wrapper did, over groups of at most 17 columns; its K3 forwards
with derivatives given the (l, n_i, n_j) scratch they took, whose peak
memory k3any reports).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.kernels import CSRC_DIR, NVCC_FLAGS, nvcc_path  # noqa: E402

OUT = os.path.join(ROOT, "build", "kernel_sweep")
P, I = ctypes.c_void_p, ctypes.c_int

K1_STMT_RANGE = re.escape(
    "hit = hit & (f[R::X + k] >= lo_r[s][k]) &\n"
    "                (f[R::X + k] <= hi_r[s][k]);")
K1_VARIANTS = {
    "checked-in (4 warps, 3 stages of 32, 1 snippet a lane at Q = 128 and "
    "2 at Q = 4096)": {},
    "1 snippet a lane at every Q": {r"FMS_WIDE_WARPS = 16;":
                                    "FMS_WIDE_WARPS = 1 << 30;"},
    "2 snippets a lane at every Q": {r"FMS_WIDE_WARPS = 16;":
                                     "FMS_WIDE_WARPS = 0;"},
    "4 snippets a lane on a wide grid": {r"FMS_SPL_WIDE = 2;":
                                         "FMS_SPL_WIDE = 4;"},
    "each category word's bit tested apart": {
        re.escape("bits = and_opaque(bits, word[s][k] >> code[k]);"):
            "bits &= word[s][k] >> code[k];"},
    "2 stages": {r"FMS_STAGES = 3;": "FMS_STAGES = 2;"},
    "4 stages": {r"FMS_STAGES = 3;": "FMS_STAGES = 4;"},
    "2 warps a block": {r"FMS_WARPS = 4;": "FMS_WARPS = 2;"},
    "3 numeric dims in registers (no padded compare at L = 3)": {
        r"FMS_LB = 4;": "FMS_LB = 3;"},
    "no range compares (wrong sums)": {K1_STMT_RANGE: ";"},
    "the count alone, no measure updates (wrong sums)": {
        re.escape("acc_s[s][j] = __fma_rn(w, f[R::MV + j], acc_s[s][j]);"):
            ";",
        re.escape("acc_q[s][j] = __fma_rn(w, f[R::MQ + j], acc_q[s][j]);"):
            ";"},
}
WIDE = r"using Wide = Tiling<4, 2, 2, 4, 16, 2>;"
NARROW = r"using Narrow = Tiling<1, 2, 8, 1, 32, 2>;"
K4_VARIANTS = {
    "checked-in (4 warps, 16 rows, 4 stages)": {},
    "1 warp a block": {r"MPA_WARPS = 4;": "MPA_WARPS = 1;"},
    "8 rows, 8 stages": {r"MPA_ROWS = 16;": "MPA_ROWS = 8;",
                         r"MPA_STAGES = 4;": "MPA_STAGES = 8;"},
    "32 rows a stage": {r"MPA_ROWS = 16;": "MPA_ROWS = 32;"},
    "6 stages": {r"MPA_STAGES = 4;": "MPA_STAGES = 6;"},
    "no FMA loop (streaming only; wrong sums)": {
        r"for \(int r = 0; r < nr; \+\+r\) \{":
            "for (int r = 0; r < min(nr, 1); ++r) {"},
}
K2_VARIANTS = {
    "checked-in": {},
    "Wide 128x128, 16 warps": {WIDE: "using Wide = Tiling<4, 2, 4, 4, 16, 1>;"},
    "Wide 128x128, 8 warps 32x64": {
        WIDE: "using Wide = Tiling<4, 2, 2, 8, 16, 1>;"},
    "Wide 32 deep a stage": {WIDE: "using Wide = Tiling<4, 2, 2, 4, 32, 2>;"},
    "Narrow 16 deep a stage": {
        NARROW: "using Narrow = Tiling<1, 2, 8, 1, 16, 2>;"},
    "Narrow as Wide (2 of 8 warps multiply at Q = 8)": {
        NARROW: "using Narrow = Tiling<4, 2, 2, 4, 16, 2>;"},
}

GRAM_BOUNDS = r"__launch_bounds__\(GT \* GR\)\nse_cov_gram\("
K3_VARIANTS = {
    "checked-in (32x32 tiles, 8 thread rows, transpose in shared memory)": {},
    "4 thread rows (128 threads, 8 rows each)": {
        r"constexpr int GR = 8;": "constexpr int GR = 4;"},
    "16 thread rows (512 threads, 2 rows each)": {
        r"constexpr int GR = 8;": "constexpr int GR = 16;"},
    "64x64 tiles (512 threads, 8 rows each)": {
        r"constexpr int GT = 32;": "constexpr int GT = 64;"},
    "at least 3 blocks an SM": {
        GRAM_BOUNDS: "__launch_bounds__(GT * GR, 3)\nse_cov_gram("},
    "at least 4 blocks an SM": {
        GRAM_BOUNDS: "__launch_bounds__(GT * GR, 4)\nse_cov_gram("},
    "(b, a) tile written directly, no transpose": {
        re.escape("tr[bl][al] = w;"):
            "if (a < n && b < n) out[(size_t)b * n + a] = w;",
        re.escape("for (int k = 0; k < L; ++k) tr[(k + 1) * GT + bl][al] "
                  "= dv[k];"):
            "for (int k = 0; k < L; ++k) if (a < n && b < n) "
            "dout[k * plane + (size_t)b * n + a] = dv[k];",
        re.escape("if (diag) return;  // uniform over the block"):
            "return;"},
}

K1ANY_VARIANTS = {
    "checked-in (4 warps, 3 stages of 32 records, 10 dims' bounds and the "
    "category words in registers)": {},
    "2 stages": {r"FMS_STAGES = 3;": "FMS_STAGES = 2;"},
    "4 stages": {r"FMS_STAGES = 3;": "FMS_STAGES = 4;"},
    "2 warps a block": {r"FMS_WARPS = 4;": "FMS_WARPS = 2;"},
    "8 dims' bounds in registers, the 9th in shared memory": {
        r"FMS_ANY_LR = 10;": "FMS_ANY_LR = 8;"},
    "12 dims' bounds in registers": {
        r"FMS_ANY_LR = 10;": "FMS_ANY_LR = 12;"},
    "16 dims' bounds in registers": {
        r"FMS_ANY_LR = 10;": "FMS_ANY_LR = 16;"},
    "category words in shared memory": {
        r"(any_vw\(int C, int V\) \{\n)  if \(C > FMS_CB\) return 0;":
            r"\1  return 0;"},
    "compares ANDed in a chain (the compiler's own order)": {
        r"for \(int n = LR / 2; n > 1; n = \(n \+ 1\) / 2\)\n#pragma unroll\n"
        r"        for \(int j = 0; j < n / 2; \+\+j\)\n"
        r"          ok\[j\] = and_opaque\(ok\[j\], ok\[n - 1 - j\]\);":
            "for (int j = 1; j < LR / 2; ++j) ok[0] &= ok[j];"},
    "no range compares (wrong sums)": {
        re.escape("ok[k / 2] = (xv.x >= lo_r[k]) & (xv.x <= hi_r[k]) &\n"
                  "                    (xv.y >= lo_r[k + 1]) & (xv.y <= "
                  "hi_r[k + 1]);"): "ok[k / 2] = 1;",
        re.escape("hit = hit & (xv >= b.x) & (xv <= b.y);"): ";"},
    "the count alone, no measure updates (wrong sums)": {
        re.escape("acc_s[j] = __fma_rn(w, mv.x, acc_s[j]);"): ";",
        re.escape("acc_q[j] = __fma_rn(w, mv.y, acc_q[j]);"): ";"},
}
K1GLOBAL_VARIANTS = {
    "checked-in (a tile of 32 snippets and 8 chunks a block, slices of 1536 "
    "category words)": {},
    "4 chunks a block": {r"FMS_G_WARPS = 8;": "FMS_G_WARPS = 4;"},
    "slices of 512 words": {r"FMS_G_SLICE = 1536;": "FMS_G_SLICE = 512;"},
    "no category passes (wrong sums)": {
        re.escape("for (int k = 0; k < C; ++k) {\n      int mx = -1;"):
            "for (int k = 0; k < 0; ++k) {\n      int mx = -1;"},
    "no range passes (wrong sums)": {
        re.escape("for (int k = 0; k < L; ++k) {\n      const double lo_k"):
            "for (int k = 0; k < 0; ++k) {\n      const double lo_k"},
}
K3ANY_VARIANTS = {
    "checked-in (Gram tiles of 8, a pair a thread; 12 dims staged and 12 "
    "derivative chains in shared memory a pass; a dim's antiderivatives "
    "phase by phase)": {},
    "16 dims a pass": {r"constexpr int AD = 12;": "constexpr int AD = 16;"},
    "antiderivatives each in turn": {
        re.escape("antideriv4<T, derivs>(u, z, c1, c2, f, df);"):
            "for (int i = 0; i < 4; ++i) antideriv<T, derivs>(u[i], z, c1, "
            "c2, &f[i], &df[i]);"},
}
K5_VARIANTS = {
    "checked-in (4 snippet tiles a block, each with its groups' warps on "
    "one ring of 2 stages of 32 rows; bounds in registers; up to 20 columns "
    "a warp)": {},
    "3 stages": {r"RMA_STAGES = 2;": "RMA_STAGES = 3;"},
    "4 stages": {r"RMA_STAGES = 2;": "RMA_STAGES = 4;"},
    "16 rows a stage, 4 stages": {r"RMA_ROWS = 32;": "RMA_ROWS = 16;",
                                  r"RMA_STAGES = 2;": "RMA_STAGES = 4;"},
    "2 snippet tiles a block": {r"RMA_TILES = 4;": "RMA_TILES = 2;"},
    "a block for each group (each group's warps read the mask apart)": {
        r"RMA_BLOCK_GROUPS = 4;": "RMA_BLOCK_GROUPS = 1;"},
    "bounds in shared memory": {r"RMA_REG_BOUNDS = true;":
                                "RMA_REG_BOUNDS = false;"},
    "up to 64 columns a warp (one group at P = 35)": {
        r"RMA_GROUP = 20;": "RMA_GROUP = 64;"},
    "up to 12 columns a warp (three groups at P = 35)": {
        r"RMA_GROUP = 20;": "RMA_GROUP = 12;"},
    "compares ANDed in a chain (the compiler's own order)": {
        re.escape("hit = and_opaque((xv.x >= lo_r[0]) & (xv.x <= hi_r[0]) &\n"
                  "                             (xv.y >= lo_r[1]) & (xv.y <= "
                  "hi_r[1]),\n"
                  "                         (xv.z >= lo_r[2]) & (xv.z <= "
                  "hi_r[2]) &\n"
                  "                             (xv.w >= lo_r[3]) & (xv.w <= "
                  "hi_r[3]));"):
            "hit = (xv.x >= lo_r[0]) & (xv.x <= hi_r[0]) & (xv.y >= lo_r[1]) "
            "& (xv.y <= hi_r[1]) & (xv.z >= lo_r[2]) & (xv.z <= hi_r[2]) & "
            "(xv.w >= lo_r[3]) & (xv.w <= hi_r[3]);"},
    "payload loads replaced by constants (wrong sums)": {
        re.escape("const float4 pv = pr[j4];"):
            "const float4 pv = make_float4(1.0f, 2.0f, 3.0f, 4.0f);"},
    "no FMA (streaming and compares only; wrong sums)": {
        re.escape("acc[4 * j4 + u] = __fmaf_rn(wv[r], v[u], acc[4 * j4 + u]);"):
            ";"},
}


def log(*a):
    print(*a, flush=True)


def build(src, variants, tag=None, text=None):
    """One library a variant (files named after ``tag``, by default the
    source's); raises if a pattern does not match exactly once or nvcc
    fails. ``text``: the source to vary, by default the checked-in one."""
    os.makedirs(OUT, exist_ok=True)
    if text is None:
        text = (CSRC_DIR / f"{src}.cu").read_text()
    procs = []
    for i, subs in enumerate(variants.values()):
        body = text
        for pat, rep in subs.items():
            body, n = re.subn(pat, rep, body)
            if n != 1:
                raise RuntimeError(f"{src}: pattern {pat!r} matched {n} times")
        cu = os.path.join(OUT, f"{tag or src}_{i}.cu")
        with open(cu, "w") as f:
            f.write(body)
        so = cu[:-3] + ".so"
        procs.append((so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so}:\n{out}")
        libs.append(ctypes.CDLL(so))
    return libs


def event_ms(fn, reps=20, inner=10):
    for _ in range(3):
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


def device_ms(fn, n=20, launches=None):
    """{kernel: device ms per call} from torch.profiler: each kernel's mean
    time over the launches the profiler recorded (it may miss some), times
    its launches a call: ``launches`` gives them for the kernels whose name
    starts with a key (default 1), raised only where the profiler recorded
    more."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            k = k.replace("void ", "")
            rec = per.setdefault(k, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.end - e.time_range.start

    def a_call(k, c):
        given = [v for pre, v in (launches or {}).items() if k.startswith(pre)]
        return max(given[0] if given else 1, -(-c // n))

    return {k: t / c * a_call(k, c) / 1e3 for k, (c, t) in per.items()}


def report(what, name, call, out, ref, launches=None):
    dev = device_ms(call, launches=launches)
    log(f"  {what} | {name}: events {event_ms(call):.6f} ms, device "
        f"{sum(dev.values()):.6f} ms ("
        + ", ".join(f"{k} {v:.6f}" for k, v in dev.items())
        + f"); bitwise the checked-in source's: {torch.equal(out, ref)}")


def k1_inputs(q_ns, t_n=60_000, seed=0):
    """A T-tuple block of a TPC-H-like relation and the first Q distinct
    snippets of a workload, for each Q (chip_smoke.py's phase 2 shapes)."""
    from repro_torch.aqp import queries as Q
    from repro_torch.aqp.plan import SnippetInterner
    from repro_torch.aqp.workload import tpch_like, tpch_workload

    rel = tpch_like(seed, n_rows=600_000)
    rows = np.random.default_rng(seed).permutation(rel.cardinality)[:t_n]
    blk = rel.take(rows)
    interner = SnippetInterner(rel.schema)
    for q in tpch_workload(seed, rel.schema, 2000):
        groups = [(g,) for g in range(3)] if q.groupby else [()]
        interner.intern(Q.decompose(rel.schema, q, groups).snippets)
    fused = interner.fused()
    return blk, {q_n: fused[np.arange(q_n)].to("cuda") for q_n in q_ns}


def sweep_k1():
    from repro_torch.kernels import RANGE_EPS
    from repro_torch.kernels.fused_masked_scan import ops as fms

    libs = build("fused_masked_scan", K1_VARIANTS)
    blk, snips = k1_inputs((128, 4096))
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    t_n, l = x.shape
    c, m = codes.shape[1], meas.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    for q_n, s in snips.items():
        v = s.cat.shape[2]
        scratch = torch.empty(fms.masked_partials_plan(t_n, q_n, m).scratch,
                              dtype=torch.float64, device="cuda")
        ref = None
        for lib, name in zip(libs, K1_VARIANTS):
            fn = lib.fms_launch
            fn.argtypes = fms._ARGTYPES["fms_launch"]
            out = torch.empty((q_n, 2 * m + 1), dtype=torch.float64,
                              device="cuda")

            def call(fn=fn, out=out, s=s):
                err = fn(x.data_ptr(), codes.data_ptr(), None,
                         meas.data_ptr(), m, s.lo.data_ptr(), s.hi.data_ptr(),
                         s.cat.data_ptr(), t_n, q_n, l, c, v, m, 0, m,
                         fms.FMS_CHUNK_T, RANGE_EPS, scratch.data_ptr(),
                         None, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"fms_launch returned {err}")

            call()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            report(f"K1 T={t_n} Q={q_n}", name, call, out, ref)
        # Other chunks through the checked-in library: another fold order,
        # so other bits by design (and K4 would have to follow).
        fn = libs[0].fms_launch
        for chunk in (128, 512):
            out = torch.empty((q_n, 2 * m + 1), dtype=torch.float64,
                              device="cuda")
            part = torch.empty((-(-t_n // chunk), q_n, 2 * m + 1),
                               dtype=torch.float64, device="cuda")

            def call(chunk=chunk, out=out, part=part, s=s):
                err = fn(x.data_ptr(), codes.data_ptr(), None,
                         meas.data_ptr(), m, s.lo.data_ptr(), s.hi.data_ptr(),
                         s.cat.data_ptr(), t_n, q_n, l, c, v, m, 0, m, chunk,
                         RANGE_EPS, part.data_ptr(), None, out.data_ptr(),
                         stream)
                if err:
                    raise RuntimeError(f"fms_launch returned {err}")

            call()
            torch.cuda.synchronize()
            report(f"K1 T={t_n} Q={q_n}", f"chunks of {chunk} (another fold "
                   "order)", call, out, ref)


def sweep_k4():
    libs = build("fused_masked_scan", K4_VARIANTS)
    rng = np.random.default_rng(0)
    t_n, m = 60_013, 2
    meas = torch.as_tensor(rng.normal(1.0, 2.0, (t_n, m)), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for q_n in (128, 4096):
        mask = (torch.rand(t_n, q_n, device="cuda", dtype=torch.float64)
                < 0.3).double()
        scratch = torch.empty((-(-t_n // 256), q_n, 2 * m + 1),
                              dtype=torch.float64, device="cuda")
        payload = torch.cat([meas, meas * meas, meas.new_ones((t_n, 1))], 1)
        log(f"K4 T={t_n} Q={q_n}: mask.T @ payload events "
            f"{event_ms(lambda: mask.T @ payload):.6f} ms, device "
            f"{sum(device_ms(lambda: mask.T @ payload).values()):.6f} ms")
        ref = None
        for lib, name in zip(libs, K4_VARIANTS):
            fn = lib.mpa_launch
            fn.argtypes = [P, P] + [I] * 7 + [P, P, P]
            out = torch.empty((q_n, 2 * m + 1), dtype=torch.float64,
                              device="cuda")

            def call(fn=fn, out=out):
                err = fn(mask.data_ptr(), meas.data_ptr(), m, t_n, q_n, m, 0,
                         m, 256, scratch.data_ptr(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"mpa_launch returned {err}")

            call()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            report(f"K4 Q={q_n}", name, call, out, ref)
        del mask


def sweep_k2():
    libs = build("gp_batch_infer", K2_VARIANTS)
    c = 2000
    stream = torch.cuda.current_stream().cuda_stream
    for q in (8, 128):
        rng = np.random.default_rng(q)
        a = rng.normal(size=(c, c))
        sinv = a @ a.T / c + np.eye(c)
        k = rng.normal(0, 0.1, (q, c))
        kappa2 = np.einsum("qc,cd,qd->q", k, sinv, k) + 0.2
        vals = (k, sinv, rng.normal(size=c), kappa2, rng.normal(size=q),
                rng.normal(size=q), rng.uniform(0.0, 0.3, q))
        for dt in (torch.float64, torch.float32):
            args = [torch.as_tensor(v, dtype=dt, device="cuda") for v in vals]
            kk, ss = args[0], args[1]
            log(f"K2 Q={q} C={c} {str(dt)[6:]}: K @ Sinv alone (cuBLAS, "
                f"a yardstick; the port never calls it) events "
                f"{event_ms(lambda: kk @ ss):.6f} ms, device "
                f"{sum(device_ms(lambda: kk @ ss).values()):.6f} ms")
            # room for every variant's partials: (Q, C/8, C/16) and (Q, C/8)
            part_g = torch.empty(q * 250 * 125, dtype=dt, device="cuda")
            part_t = torch.empty(q * 250, dtype=dt, device="cuda")
            out = torch.empty((3, q), dtype=dt, device="cuda")
            ref = None
            for lib, name in zip(libs, K2_VARIANTS):
                fn = getattr(lib, "gp_launch_f64" if dt == torch.float64
                             else "gp_launch_f32")
                fn.argtypes = [P] * 7 + [I] * 3 + [P] * 6

                def call(fn=fn):  # C_split 2048: the fill C = 2000 covers
                    err = fn(*[x.data_ptr() for x in args], q, c, 2048,
                             part_g.data_ptr(), part_t.data_ptr(),
                             out[0].data_ptr(), out[1].data_ptr(),
                             out[2].data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"gp_launch returned {err}")

                call()
                torch.cuda.synchronize()
                ref = out.clone() if ref is None else ref
                report(f"K2 Q={q} C={c} {str(dt)[6:]}", name, call, out, ref)


def sweep_k3():
    libs = build("se_covariance", K3_VARIANTS)
    n, l, sigma2 = 2000, 3, 1.7
    rng = np.random.default_rng(3)
    lo = rng.uniform(0.0, 0.6, (n, l))
    vals = (lo, lo + rng.uniform(0.05, 0.45, (n, l)),
            rng.uniform(0.3, 1.5, l), rng.uniform(0.5, 2.0, n))
    lo_t, hi_t, ls_t, norm_t = (torch.as_tensor(v, device="cuda")
                                for v in vals)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((n, n), dtype=torch.float64, device="cuda")
    dout = torch.empty((l, n, n), dtype=torch.float64, device="cuda")
    general = libs[0].se_cov_launch_f64
    general.argtypes = [P] * 7 + [ctypes.c_double] + [I] * 3 + [P] * 3
    ptrs = [t.data_ptr() for t in (lo_t, hi_t)]

    def call_general():
        err = general(*ptrs, *ptrs, ls_t.data_ptr(), norm_t.data_ptr(),
                      norm_t.data_ptr(), sigma2, n, n, l, out.data_ptr(),
                      None, stream)
        if err:
            raise RuntimeError(f"se_cov_launch_f64 returned {err}")

    call_general()
    torch.cuda.synchronize()
    ref_general = out.clone()
    report(f"K3 n={n} l={l} float64", "general kernel, checked-in",
           call_general, out, ref_general)
    for derivs in (False, True):
        ref = None
        for lib, name in zip(libs, K3_VARIANTS):
            fn = lib.se_cov_gram_launch_f64
            fn.argtypes = [P] * 4 + [ctypes.c_double] + [I] * 2 + [P] * 3

            def call(fn=fn):
                err = fn(*ptrs, ls_t.data_ptr(), norm_t.data_ptr(), sigma2,
                         n, l, out.data_ptr(),
                         dout.data_ptr() if derivs else None, stream)
                if err:
                    raise RuntimeError(f"se_cov_gram_launch_f64 returned "
                                       f"{err}")

            call()
            torch.cuda.synchronize()
            got = torch.cat([out.reshape(-1), dout.reshape(-1)]) if derivs \
                else out.clone()
            ref = got.clone() if ref is None else ref
            assert torch.equal(out, ref_general), name
            report(f"K3 Gram n={n} l={l} float64"
                   + (" with derivatives" if derivs else ""), name, call,
                   got, ref)


def baseline_source(baseline, name):
    """The text of ``csrc/<name>.cu`` in ``baseline`` (a directory, or a git
    revision of this checkout), or None where it cannot be had."""
    if baseline is None:
        return None
    if os.path.isdir(baseline):
        path = os.path.join(baseline, f"{name}.cu")
        return open(path).read() if os.path.exists(path) else None
    out = subprocess.run(
        ["git", "-C", ROOT, "show",
         f"{baseline}:src/repro_torch/csrc/{name}.cu"],
        capture_output=True, text=True)
    return out.stdout if out.returncode == 0 else None


def k1any_inputs(seed=0, t_n=60_000, q_n=128):
    """A T-tuple block of chip_smoke.py's phase 4 wide relation (9 numeric
    dims, 9 measures) and the first Q distinct snippets of its warm-up
    workload."""
    from repro_torch.aqp import queries as Q
    from repro_torch.aqp.plan import SnippetInterner
    from repro_torch.aqp.workload import make_relation, make_workload

    rel = make_relation(seed + 5, 600_000, n_num=9, n_measures=9)
    rows = np.random.default_rng(seed + 24).permutation(rel.cardinality)
    blk = rel.take(rows[:t_n])
    interner = SnippetInterner(rel.schema)
    for q in make_workload(seed + 6, rel.schema, 200):
        groups = [(g,) for g in range(3)] if q.groupby else [()]
        interner.intern(Q.decompose(rel.schema, q, groups).snippets)
    return blk, interner.fused()[np.arange(q_n)].to("cuda")


def takes_words(text):
    """Whether a fused_masked_scan.cu's fms_launch takes path 3's category
    words."""
    sig = re.search(r'extern "C" int fms_launch\(([^)]*)\)', text)
    return sig is not None and "uint32_t* words" in sig.group(1)


def k1_call(lib, blk, s, out, scratch, stream, words=None, old=False):
    """K1 over every measure of ``blk``, one launch a group of at most 8
    (the wrapper's groups), through ``lib``'s C entry point; ``words``:
    path 3's category scratch; ``old``: a library from before that
    argument. ``blk`` has ``num_normalized``, ``cat`` and
    ``measures``; ``s`` has ``lo``, ``hi`` and ``cat``."""
    from repro_torch.kernels import RANGE_EPS
    from repro_torch.kernels.fused_masked_scan import ops as fms

    fn = lib.fms_launch
    fn.argtypes = fms._ARGTYPES["fms_launch"][:-1 if old else None]
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    (t_n, l), c, m = x.shape, codes.shape[1], meas.shape[1]
    q_n, v = s.cat.shape[0], s.cat.shape[2]
    extra = () if old else (None if words is None else words.data_ptr(),)

    def call():
        for first, count in fms.measure_groups(m):
            err = fn(x.data_ptr(), codes.data_ptr(), None,
                     meas.data_ptr() + 8 * first, m, s.lo.data_ptr(),
                     s.hi.data_ptr(), s.cat.data_ptr(), t_n, q_n, l, c, v,
                     count, first, m, fms.FMS_CHUNK_T, RANGE_EPS,
                     scratch.data_ptr(), *extra, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"fms_launch returned {err}")
    return call


def sweep_k1any(baseline):
    from repro_torch.kernels.fused_masked_scan import ops as fms

    libs = build("fused_masked_scan", K1ANY_VARIANTS, tag="k1any")
    blk, s = k1any_inputs()
    t_n, m = blk.measures.shape
    q_n = s.cat.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty((-(-t_n // 256), q_n, 17), dtype=torch.float64,
                          device="cuda")
    folds = {"mpa_fold": len(fms.measure_groups(m))}
    ref = None
    for lib, name in zip(libs, K1ANY_VARIANTS):
        out = torch.empty((q_n, 2 * m + 1), dtype=torch.float64,
                          device="cuda")
        call = k1_call(lib, blk, s, out, scratch, stream)
        call()
        torch.cuda.synchronize()
        ref = out.clone() if ref is None else ref
        report(f"K1 any width T={t_n} Q={q_n} L=9 M={m}", name, call, out,
               ref, launches=folds)
    text = baseline_source(baseline, "fused_masked_scan")
    if text is None:
        log(f"  K1 any width: no baseline source ({baseline!r}): not "
            "checked against an earlier version")
        return
    (lib,) = build("fused_masked_scan", {"baseline": {}}, tag="k1base",
                   text=text)
    out = torch.empty_like(ref)
    old = not takes_words(text)
    k1_call(lib, blk, s, out, scratch, stream, old=old)()
    torch.cuda.synchronize()
    log(f"  K1 any width: bitwise the baseline's ({baseline}): "
        f"{torch.equal(out, ref)}")
    report(f"K1 any width T={t_n} Q={q_n} L=9 M={m}",
           f"baseline ({baseline})", k1_call(lib, blk, s, out, scratch,
                                              stream, old=old), out, ref,
           launches=folds)


def k1global_inputs(v, t_n=60_000, q_n=128, seed=0):
    """chip_smoke.py's path-3 shape: the first T tuples of phase 2's block
    and Q of its snippets with one more categorical dim of ``v`` values
    (codes uniform, each snippet's set ~70% of them)."""
    from types import SimpleNamespace

    blk, snips = k1_inputs((q_n,), seed=seed)
    s = snips[q_n]
    rng = np.random.default_rng(seed + 26)
    t_all = blk.measures.shape[0]
    extra = torch.as_tensor(rng.integers(0, v, (t_all, 1)),
                            dtype=blk.cat.dtype, device="cuda")
    q0, c0, v0 = s.cat.shape
    sets = s.cat.new_zeros((q0, c0 + 1, v))
    sets[:, :-1, :v0] = s.cat
    sets[:, -1] = torch.as_tensor(rng.uniform(size=(q0, v)) < 0.7,
                                  device="cuda")
    b = SimpleNamespace(
        num_normalized=blk.num_normalized[:t_n].contiguous(),
        cat=torch.cat([blk.cat, extra], 1)[:t_n].contiguous(),
        measures=blk.measures[:t_n].contiguous())
    return b, SimpleNamespace(lo=s.lo, hi=s.hi, cat=sets)


def sweep_k1global(baseline):
    """K1 path 3 (category sets past a block's shared memory) at
    chip_smoke.py's shape (T = 60,000, Q = 128, a dim of 30,000 values,
    M = 2), and on 3,000 tuples with a dim of 100,000 values (words past
    one block's shared memory): variants, and the baseline's bits."""
    from repro_torch.kernels.fused_masked_scan import ops as fms

    libs = build("fused_masked_scan", K1GLOBAL_VARIANTS, tag="k1global")
    text = baseline_source(baseline, "fused_masked_scan")
    base = (build("fused_masked_scan", {"baseline": {}}, tag="k1gbase",
                  text=text)[0] if text is not None else None)
    stream = torch.cuda.current_stream().cuda_stream
    for v, t_n in ((30_000, 60_000), (100_000, 3_000)):
        blk, s = k1global_inputs(v, t_n=t_n)
        (_, l), c = blk.num_normalized.shape, blk.cat.shape[1]
        q_n, m = s.cat.shape[0], blk.measures.shape[1]
        plan = fms.fused_scan_plan(t_n, q_n, m, l, c, v)
        assert plan.path == 3, plan
        scratch = torch.empty((-(-t_n // 256), q_n, 2 * m + 1),
                              dtype=torch.float64, device="cuda")
        words = torch.empty(plan.word_scratch, dtype=torch.int32,
                            device="cuda")
        what = f"K1 path 3 T={t_n} Q={q_n} C={c} V={v} M={m}"
        ref = None
        for lib, name in zip(libs, K1GLOBAL_VARIANTS):
            out = torch.empty((q_n, 2 * m + 1), dtype=torch.float64,
                              device="cuda")
            call = k1_call(lib, blk, s, out, scratch, stream, words=words)
            call()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            report(what, name, call, out, ref)
        if base is None:
            log(f"  {what}: no baseline source ({baseline!r})")
            continue
        out = torch.empty_like(ref)
        old = not takes_words(text)
        call = k1_call(base, blk, s, out, scratch, stream,
                       words=None if old else words, old=old)
        call()
        torch.cuda.synchronize()
        log(f"  {what}: bitwise the baseline's ({baseline}): "
            f"{torch.equal(out, ref)}")
        report(what, f"baseline ({baseline})", call, out, ref)


def k3_entries(lib, old):
    """(general, Gram, reduction) f64 entry points of ``lib``; ``old``: a
    library whose forwards take the (l, n_i, n_j) scratch."""
    D, LL = ctypes.c_double, ctypes.c_longlong
    general, gram = lib.se_cov_launch_f64, lib.se_cov_gram_launch_f64
    extra = [P] if old else []
    general.argtypes = [P] * 7 + [D] + [I] * 3 + [P] * 3 + extra
    gram.argtypes = [P] * 4 + [D] + [I] * 2 + [P] * 3 + extra
    red = lib.se_cov_reduce_launch_f64
    red.argtypes = [P, P, LL, I, P, P, P]
    return general, gram, red


def sweep_k3any(baseline):
    """K3's kernels for any l at l = 12 and 9: the general forward at
    improve's 128 x 2000, the Gram forward at 2000 x 2000 with and without
    derivatives, the reduction of 2000 x 2000 derivatives; variants, the
    baseline's bits and its peak memory (its (l, n, n) scratch)."""
    libs = build("se_covariance", K3ANY_VARIANTS, tag="k3any")
    text = baseline_source(baseline, "se_covariance")
    base = (build("se_covariance", {"baseline": {}}, tag="k3base",
                  text=text)[0] if text is not None else None)
    old = text is not None and "double* gs" in text
    stream = torch.cuda.current_stream().cuda_stream
    f64 = dict(dtype=torch.float64, device="cuda")
    n, ni, sigma2 = 2000, 128, 1.7
    for l in (12, 9):
        rng = np.random.default_rng(23 + l)

        def ranges(k):
            lo = rng.uniform(0.0, 0.6, (k, l))
            return (torch.as_tensor(lo, **f64),
                    torch.as_tensor(lo + rng.uniform(0.05, 0.45, (k, l)),
                                    **f64))
        lo_i, hi_i = ranges(ni)
        lo, hi = ranges(n)
        ls = torch.as_tensor(rng.uniform(0.3, 1.5, l), **f64)
        nrm_i = torch.as_tensor(rng.uniform(0.5, 2.0, ni), **f64)
        nrm = torch.as_tensor(rng.uniform(0.5, 2.0, n), **f64)
        g_out = torch.as_tensor(rng.normal(size=(n, n)), **f64)
        part = torch.empty((-(-n * n // 2048), l), **f64)
        outs = {}

        def calls(lib, is_old):
            general, gram, red = k3_entries(lib, is_old)
            o_g = torch.empty((ni, n), **f64)
            o_n = torch.empty((n, n), **f64)
            o_d = torch.empty((n, n), **f64)
            d = torch.empty((l, n, n), **f64)
            gs = [torch.empty((l, n, n), **f64).data_ptr()] if is_old else []
            gs_g = [None] if is_old else []
            grad = torch.empty(l, **f64)

            def c_general():
                assert not general(
                    lo_i.data_ptr(), hi_i.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), ls.data_ptr(), nrm_i.data_ptr(),
                    nrm.data_ptr(), sigma2, ni, n, l, o_g.data_ptr(), None,
                    *gs_g, stream)

            def c_gram():
                assert not gram(lo.data_ptr(), hi.data_ptr(), ls.data_ptr(),
                                nrm.data_ptr(), sigma2, n, l, o_n.data_ptr(),
                                None, *gs_g, stream)

            def c_derivs():
                assert not gram(lo.data_ptr(), hi.data_ptr(), ls.data_ptr(),
                                nrm.data_ptr(), sigma2, n, l, o_d.data_ptr(),
                                d.data_ptr(), *gs, stream)

            def c_reduce():
                assert not red(g_out.data_ptr(), d.data_ptr(), n * n, l,
                               part.data_ptr(), grad.data_ptr(), stream)
            return {"general 128x2000": (c_general, o_g),
                    "Gram 2000x2000": (c_gram, o_n),
                    "Gram 2000x2000 with derivatives": (c_derivs, d),
                    "reduction 2000x2000": (c_reduce, grad)}

        named = list(zip(libs, K3ANY_VARIANTS, [False] * len(libs)))
        if base is not None:
            named.append((base, f"baseline ({baseline})", old))
        for lib, name, is_old in named:
            cs = calls(lib, is_old)
            cs["Gram 2000x2000 with derivatives"][0]()  # D for the reduction
            for shape, (call, out) in cs.items():
                call()
                torch.cuda.synchronize()
                outs.setdefault(shape, out.clone())
                report(f"K3 any l, {shape} l={l} float64", name, call, out,
                       outs[shape], launches={"se_cov_fold": 1})
            del cs
        if base is None:
            log(f"  K3 any l: no baseline source ({baseline!r})")
            continue
        # Peak device memory of a Gram call with derivatives, as each
        # version's wrapper allocates it (the scratch's: out, D and it).
        for lib, name, is_old in ((libs[0], "checked-in", False),
                                  (base, "baseline", old)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, gram, _ = k3_entries(lib, is_old)
            o = torch.empty((n, n), **f64)
            d = torch.empty((l, n, n), **f64)
            gs = [torch.empty((l, n, n), **f64).data_ptr()] if is_old else []
            assert not gram(lo.data_ptr(), hi.data_ptr(), ls.data_ptr(),
                            nrm.data_ptr(), sigma2, n, l, o.data_ptr(),
                            d.data_ptr(), *gs, stream)
            torch.cuda.synchronize()
            log(f"  K3 any l, Gram 2000x2000 with derivatives l={l}, {name}: "
                f"peak {(torch.cuda.max_memory_allocated() - before) / 1e6:.3f}"
                " MB allocated for the call")
            del o, d, gs


def k5_call(lib, args, p, out, scratch, stream, group=None):
    """K5 over ``p`` payload columns through ``lib``'s C entry point: one
    launch, or (``group``) one a run of at most ``group`` columns, each on
    its own columns, as an earlier wrapper did."""
    from repro_torch.kernels import RANGE_EPS
    from repro_torch.kernels.range_mask_agg import ops as rma

    fn = lib.rma_launch
    fn.argtypes = rma._ARGTYPES["rma_launch"]
    x, pay, lo, hi, extra = args
    (t_n, l), q_n = x.shape, lo.shape[0]
    runs = ([(0, p)] if group is None else
            [(j, min(group, p - j)) for j in range(0, p, group)])

    def call():
        for first, count in runs:
            err = fn(x.data_ptr(), pay.data_ptr() + 4 * first, p,
                     lo.data_ptr(), hi.data_ptr(), extra.data_ptr(), t_n,
                     q_n, l, count, rma.RMA_CHUNK_T, RANGE_EPS,
                     scratch.data_ptr(), out.data_ptr() + 4 * first, p,
                     stream)
            if err:
                raise RuntimeError(f"rma_launch returned {err}")
    return call


def k5_inputs(seed=0, t_n=60_013, q_n=128):
    """K5's inputs at chip_smoke.py's phase 2 shapes: a T-tuple block of a
    TPC-H-like relation, the first Q distinct snippets of a workload and
    their categorical mask; payloads [m, m^2, 1] of its 2 measures (P = 5)
    and of 17 measures made from them (P = 35)."""
    from repro_torch.kernels.range_mask_agg import ops as rma

    blk, snips = k1_inputs((q_n,), t_n=t_n, seed=seed)
    s = snips[q_n]
    f32 = torch.float32
    meas = blk.measures.to(f32)
    m17 = meas[:, :1].repeat(1, 17) + torch.arange(17, device="cuda")
    pays = {p: torch.cat([m, m * m, m.new_ones((t_n, 1))], 1)
            for p, m in ((5, meas), (35, m17))}
    extra = rma.categorical_premask(blk.cat, s.cat)
    return (blk.num_normalized.to(f32), s.lo.to(f32), s.hi.to(f32),
            extra), pays


def sweep_k5(baseline):
    libs = build("range_mask_agg", K5_VARIANTS, tag="k5")
    (x, lo, hi, extra), pays = k5_inputs()
    t_n, q_n = extra.shape
    stream = torch.cuda.current_stream().cuda_stream
    text = baseline_source(baseline, "range_mask_agg")
    base = (build("range_mask_agg", {"baseline": {}}, tag="k5base",
                  text=text)[0] if text is not None else None)
    if base is None:
        log(f"  K5: no baseline source ({baseline!r}): not checked against "
            "an earlier version")
    for p, pay in pays.items():
        args = (x, pay, lo, hi, extra)
        scratch = torch.empty((-(-t_n // 256), q_n, p), dtype=torch.float32,
                              device="cuda")
        ref = None
        for lib, name in zip(libs, K5_VARIANTS):
            out = torch.empty((q_n, p), dtype=torch.float32, device="cuda")
            call = k5_call(lib, args, p, out, scratch, stream)
            call()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            report(f"K5 T={t_n} Q={q_n} P={p}", name, call, out, ref)
        if base is not None:
            out = torch.empty_like(ref)
            call = k5_call(base, args, p, out, scratch, stream, group=17)
            call()
            torch.cuda.synchronize()
            log(f"  K5 P={p}: bitwise the baseline's ({baseline}): "
                f"{torch.equal(out, ref)}")
            runs = -(-p // 17)  # the baseline launches once a 17 columns
            report(f"K5 T={t_n} Q={q_n} P={p}", f"baseline ({baseline})",
                   call, out, ref, launches={"rma_partials": runs,
                                             "rma_fold_chunks": runs})


def main():
    sweeps = {"k1": sweep_k1, "k1any": sweep_k1any, "k4": sweep_k4,
              "k2": sweep_k2, "k3": sweep_k3, "k5": sweep_k5,
              "k1global": sweep_k1global, "k3any": sweep_k3any}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*",
                    help=f"the sweeps to run, of {sorted(sweeps)} (default: "
                         "every one)")
    ap.add_argument("--baseline", default=None,
                    help="a git revision or a directory of earlier K1, K3 "
                         "and K5 sources to check the kernels' bits against")
    args = ap.parse_args()
    unknown = set(args.kernels) - set(sweeps)
    if unknown:
        ap.error(f"no sweep named {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("kernel_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    for name in args.kernels or list(sweeps):
        if name in ("k1any", "k5", "k1global", "k3any"):
            sweeps[name](args.baseline)
        else:
            sweeps[name]()
    log(f"sweep done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
