#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Verdict on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device and build: card name and power limit, nvcc build of every kernel
     under src/repro_torch/csrc (timed), TF32 off;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with CUDA-event timings and bounds (the
     fused scan's rows the same at Q = 128 and Q = 4096, and a floor from
     the instructions ``cuobjdump -sass`` finds in its stage loop; the
     SE-covariance kernels included: the premise that their antiderivative
     is even bit for bit, the general and Gram forwards, the forward with
     derivatives and the lengthscale gradient reduced from them, and a
     bound from the FP64 instructions ``cuobjdump -sass`` finds in one
     antiderivative; range-mask aggregation at 5 and 35 payload columns);
     then past the widths one launch takes: the fused scan and masked
     partials at 12 measures, the fused scan's kernel for any width on
     phase 4's 9 x 9 relation (and on the main path's block padded with
     neutral dims, bitwise the register path), its kernel for category
     sets past a block's shared memory (a dim of 30,000 values, and one of
     100,000 on a small block), the SE covariance at 12 numeric dims (the
     kernels for any l: general, Gram with and without derivatives, the
     reduction, and the device memory a call takes); group discovery at
     the SF10 cell's first batch (599,861 tuples) with 1 and 16 probes on
     its table and sorted routes, bitwise the plain version;
  3. the main path at a size users run: TPC-H SF1 lineitem cardinality
     (6,001,215 rows), capacity 2000, a 2000-query warm-up through
     ``execute_many`` and 200 queries served one by one through ``execute``;
  6. learning and checkpoints on phase 3's engine: ``refit()`` with its
     defaults (the NLL must fall on every synopsis; every Adam step runs the
     SE-covariance Gram forward with derivatives and their reduction), ``save_synopses`` /
     ``load_synopses`` into a fresh engine (bitwise state, then 20 queries
     answered bitwise alike), 200 fresh queries after the refit, and a
     drifted data append on every synopsis;
  5. the ``connect``/``Session`` facade on phase 3's relation, locally and
     over a four-shard ``Mesh`` on the one card: the mesh session must
     answer bitwise like the local one and scan through the
     ``masked_partials`` kernel once per round, also after
     ``Session.refit()``; then the ``range_mask_agg`` kernel through the
     scan placement over every sample batch, against the fused scan;
  7. workload intelligence on phase 3's relation: ``connect(rel, cfg,
     cache=True)`` and cache-free twins on one warm-up; a stream of fresh
     queries, exact repeats, subsumed ones (a subset or a pin of a cached
     group-by, a box within the predicate epsilon) and uncacheable ones:
     every miss bitwise the twin fed the misses, every hit bitwise its
     cached cells and launching no kernel; q/s and p50 of the cached and a
     cache-free session on the same stream; the intel payload through a
     checkpoint; a full-accuracy entry refused after an append; the
     router's learned "scan" route, bitwise an always-improve twin and
     identical under both ingest modes;
  8. the microbatching ``AqpService`` (``Session.serve``) on phase 3's
     relation: 256 queries from 8 threads at once through the auto-flush
     (every ticket resolved exactly once, every answer bitwise a twin's
     ``execute_many`` of the same flushes, launches counted, q/s and ticket
     latency beside the same queries one by one); again with
     ``ingest_max_pending=2`` (answers and final store bitwise an
     ``async_ingest=False`` twin, no backlog past 2); a transient and a
     persistent scan fault; a deadline of 0 s and the answer cache's
     pre-screen (no launch across a hit); the service over a four-shard
     mesh, bitwise the local one, through the masked-partials kernel;
  9. the multi-tenant ``ServingFront`` on phase 3's relation through
     ``serve_http`` on 127.0.0.1, driven with ``urllib`` only: two shared
     tenants and an isolated one warmed with 200 queries (and two twins);
     192 fresh queries from 24 client threads (every HTTP answer bitwise a
     twin's ``execute_many`` of the same flushes, K1 launches equal to the
     flushes' scan rounds across two engines flushing at once, q/s and
     request latency); web's answers asked as bi (exact hits of the shared
     cache, bitwise, no launch); chunked NDJSON streams (the final line
     bitwise a twin's ``execute``) and explain; 429 / 503 / 400 / 404 and
     healthz over the wire; shutdown leaving no handler thread;
  4. the slice against its plain path: a CUDA engine and a CPU engine on the
     same 600,000-row data must agree, before and after a short refit of
     both, and again on a 600,000-row relation of 9 numeric dims and 9
     measures (run last; phases 6 and 5 reuse phase 3's relation), whose
     refit runs K3's kernels for any l; then those kernels held against
     their plain versions at every shape that engine launched and at
     ragged ones, and timed at the shapes it launched most;
 10. the LM stack's serving path (plain PyTorch, no kernel of its own):
     qwen2.5-3b at full width and depth in bf16 (random weights from
     ``init_params`` on the card), a 4 x 512 prefill and 32 decode steps
     teacher-forced on a random continuation, every step's logits held
     against the forward over the same tokens (argmax compared with each
     step's own input token masked), the greedy loop timed for prefill and
     decode (B = 4 and 1) beside their bounds, and peak memory; the card
     against the CPU in float32 on the same weights for qwen2.5-3b,
     rwkv6-3b and hymba-1.5b at full width and cut depth (``forward`` logits and a 16-token ``generate``),
     the chunked RWKV6 and Mamba mixers against their sequential oracles;
     and decode against prefill for every smoke config;
 11. the LM stack's training path (plain PyTorch autograd, no kernel of
     its own): qwen2.5-3b at full width and depth in bf16 with AdamW, a
     warm-up and three timed steps of 2 x 4 x 512 tokens from the
     ``TokenPipeline`` (recomputation on, the trainer's cosine schedule),
     step ms, tokens/s and the shares of the 6NT (``mfu``), 8NT and AdamW
     bytes bounds, peak memory, then three steps on one fixed batch whose
     loss must fall; two steps from one state bitwise equal (the cut
     model in bf16); one AdamW step (and one Adafactor step) on the card
     against the CPU in float32 at full width and cut depth; every smoke
     config's accum 2 on [x, x] against accum 1, recomputation on against
     off; the trainer's crash-and-resume and a bf16 checkpoint on the
     card;
 12. the static checker's trace layer (``repro_torch.analysis``, T001-T007)
     on the card: ``run_trace_rules(device="cuda")`` over the nine
     scan-plane programs and the improve ladder with no gating finding;
     T005 on the fused scan at the main path's block (T = 60,013) at Q =
     128 and 4096: no (T, Q) tensor and a peak memory delta below T * Q * 8
     bytes, printed, with the plain scan under the ``fused`` tag flagged as
     the negative control; T007 keyed by K2's plan from the built library;
     T003 over a four-shard mesh on the one card; K1, K4 and K2 launched
     during the phase, and its seconds;
 13. the distributed layer (plain PyTorch, no kernel of its own): one
     arctic-480b MoE layer at full width (26.8 GB of bf16 experts) at its
     capacity factor over (data 2, model 2) and (data 1, model 4) meshes of
     the card, held against each batch shard's single-device MoE and run
     twice bitwise, timed, with peak memory; qwen2.5-3b's compressed train
     step at full width and depth over (pod 2, data 1, model 1): every
     payload crossing between pods int8 (a float32 scale a leaf), the mean
     the optimizer gets within the int8 bound of the exact mean of the
     pods' float32 gradients, the loss the pods' mean, step time, bytes
     exchanged and peak memory; qwen2.5-3b's parameters and AdamW state
     (full width, cut depth) placed under FSDP_RULES on (data 4, model 1),
     through a checkpoint and resharded onto (data 2, model 1), bitwise;
     the crossings between mesh positions of the MoE layer's first run and
     the checked step recorded (``record_collectives``);
 14. the launch layer (plain PyTorch, no kernel of its own): the 66 launch
     cells (33 x single and multi pod) over the abstract production meshes
     of the ``meta`` device, a line each (probes and their multipliers,
     argument bytes a position, whether they fit the card), the probes'
     outputs evaluated on meta but for the kinds that cost seconds there;
     five probes on the card at their cells' shapes (qwen2.5-3b's decode
     layer at batch 128 over a 32,784-slot cache, its train layer forward
     at 16 x 4096 tokens and vjp at 8 x 4096 (cut: 16 does not fit the
     card), rwkv6-3b's chunk forward and vjp):
     median time, FLOPs counted on the card equal to those on meta, the
     roofline bound of their FLOPs and the bytes of their inputs and
     outputs, peak memory; phase 13's recorded collective bytes: the
     compressed step's collective-permute bytes a pod equal to phase 13's
     bytes exchanged / 2, the MoE layer's all-reduce bytes equal to the
     shapes' reckoning.
The last two lines of standard output are the kernels' JSON record and the
device record ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import functools
import gc
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
# Phase 4 holds every cell's 95% half-width (the square root of its beta^2)
# to this fraction of the other engine's, as it holds COUNT and SUM
# estimates to a tenth of their half-width. The spread is in the FREQ
# synopsis' improved variance: gamma^2 = kappa^2 - k Sigma^-1 k^T cancels
# about seven digits at 600,000 rows (kappa^2 0.5715, gamma^2 5.5e-8;
# cond(Sigma^-1) 3.8e8), so a last-bit difference of the quadratic form
# between summation orders moves gamma^2, and the cell's beta^2, by percents.
HALF_WIDTH_RTOL = 0.1
K1_REPLACES = "src/repro/kernels/fused_masked_scan/kernel.py:84"
K2_REPLACES = "src/repro/kernels/gp_batch_infer/kernel.py:27"
K4_REPLACES = "src/repro/kernels/fused_masked_scan/kernel.py:133"
K5_REPLACES = "src/repro/kernels/range_mask_agg/kernel.py:25"
K3_REPLACES = "src/repro/kernels/se_covariance/kernel.py:35"
# K6 replaces no Pallas kernel: the reference's host np.unique over its jnp
# predicate mask.
K6_REPLACES = "src/repro/core/engine.py:200"
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


def device_ms_per_call(label, fn, n=10, windows=3, launches=None):
    """Device time per call of ``fn`` from the profiler, with its split by
    kernel: over ``windows`` profiler windows of ``n`` calls each, each
    kernel's median over the windows of its mean time over the launches
    the window recorded, times its launches a call. ``launches`` gives the
    launches a call of the kernels whose name starts with a key (default
    1); the profiler may miss launches, so it only raises that count where
    it recorded more. A window that recorded nothing is run again, up to
    two more times; None when none recorded device activity."""
    per_window, tries = [], 0
    while len(per_window) < windows and tries < windows + 2:
        tries += 1
        _, _, per = device_profile(fn, n)
        if per:
            per_window.append(per)
    if not per_window:
        log(f"  {label}: the profiler recorded no device activity "
            "(device time not measured)")
        return None

    def a_call(name, recorded):
        given = [k for pre, k in (launches or {}).items()
                 if _short(name).removeprefix("void ").startswith(pre)]
        return max(given[0] if given else 1, -(-recorded // n))

    names = set().union(*per_window)
    each = {k: float(np.median([1e3 * w[k][1] / w[k][0] * a_call(k, w[k][0])
                                for w in per_window if k in w]))
            for k in names}
    log(f"  {label}: device {sum(each.values()):.6f} ms per call (median of "
        f"{len(per_window)} windows of {n} calls; "
        + ", ".join(f"{_short(k)} {each[k]:.6f} ms"
                    for k in sorted(each, key=lambda k: -each[k]))
        + ")")
    return sum(each.values())


def ptxas_summary(out):
    """``{kernel: "N registers, ... smem, spills"}`` from ``nvcc -Xptxas -v``
    output: one line per compiled entry function."""
    import re

    res, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res.setdefault(name, {})["spills"] = (
                f"spill stores {m.group(1)} B, loads {m.group(2)} B")
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            res.setdefault(name, {})["used"] = (
                f"{m.group(1)} registers, static smem "
                f"{smem.group(1) if smem else 0} B")
    names = list(res)
    try:  # demangle where the toolkit's c++filt is at hand
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        shown = [n.replace("(anonymous namespace)::", "")
                 for n in out.stdout.splitlines()]
    except (OSError, subprocess.CalledProcessError):
        shown = names
    if len(shown) != len(names):
        shown = names
    return {d: ", ".join(res[k][f] for f in ("used", "spills")
                         if f in res[k])
            for k, d in zip(names, shown)}


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
    # The kernels redesigned for Hopper (K1 at the main path's M = 2 with
    # 32-bit category words and for any width at M = 8 and 1, K4, K2, K5 at
    # P = 5 and 35, and K3 at the main path's l = 3 in f64): what ptxas gave
    # each entry function (dynamic shared memory is set at launch: K1 45 KB
    # a block at M = 2, 55 KB at 2 snippets a lane, 93 KB for any width at
    # L = 9, M = 8; K4 24 KB a block at M = 2, K2 86 KB in f64 and 43 KB in
    # f32, K5 76 KB at P = 5; the K3 Gram kernel's transpose 8.4 KB, 33.8
    # KB with derivatives at l = 3).
    for src, keys in (("fused_masked_scan", ("mpa_", "fms_partials<2, 1,",
                                             "fms_partials_any<8, 1>",
                                             "fms_partials_any<1, 1>",
                                             "fms_partials_stream<2>",
                                             "fms_words")),
                      ("gp_batch_infer", ("gp_",)),
                      ("range_mask_agg", ("rma_partials<5>",
                                          "rma_partials<18>", "rma_fold")),
                      ("se_covariance", ("<double, 3",
                                         "se_cov_any<double",
                                         "se_cov_reduce_any<double")),
                      ("group_discovery", ("gd_mark",))):
        for fn, what in ptxas_summary(logs.get(src, "")).items():
            if any(k in fn for k in keys):
                log(f"ptxas {src}: {fn}: {what}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)
    return smi


# ------------------------------------------------------------------ phase 2
def _fused_snippets(rel, seed, n_queries, q_n, workload=None):
    """The first ``q_n`` distinct snippets of a workload (host): a tpch
    workload unless ``workload`` (a function of seed, schema and count)
    names another."""
    from repro_torch.aqp import queries as Q
    from repro_torch.aqp.plan import SnippetInterner
    from repro_torch.aqp.workload import tpch_workload

    interner = SnippetInterner(rel.schema)
    for q in (workload or tpch_workload)(seed, rel.schema, n_queries):
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
        "sums/sumsq rtol 1e-11, repeat bitwise, a snippet's row the same at "
        "Q = 128 and Q = 4096")
    dev = rel.device
    rows = np.random.default_rng(seed).permutation(rel.cardinality)[:60_000]
    blk = rel.take(rows)
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    t_n, l = x.shape
    c, m = codes.shape[1], meas.shape[1]
    clock = max_sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    records, outs, per_tuple = {}, {}, {}
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
        outs[q_n] = got
        err = float((got - want).abs().max())
        v = s.cat.shape[2]
        plan = fms.fused_scan_plan(t_n, q_n, m, l, c, v)
        log(f"  fused_masked_scan Q={q_n}: path {plan.path}, {plan.spl} "
            f"snippets a lane, {plan.blocks} blocks of "
            f"{plan.tile_q // (32 * plan.spl)} warps, {plan.smem} B of shared "
            f"memory a block, {plan.rows} tuples a ring stage")
        if plan.spl not in per_tuple:
            per_tuple[plan.spl] = k1_sass_count(plan.spl, plan.rows)[0]
        ms = time_ms(lambda: fms.fused_masked_scan(*args), inner=10)
        plain = time_ms(lambda: fused_masked_scan_ref(
            x, codes, None, meas, s.lo, s.hi, s.cat), reps=20 if q_n <= 128
            else 5)
        n_bytes = (t_n * (8 * l + 4 * c + 8 * m) + q_n * (16 * l + c * v)
                   + q_n * (2 * m + 1) * 8)
        n_ops = t_n * q_n * (2 * l + c + 2 * (2 * m + 1))
        records[q_n] = report("fused_masked_scan", f"T={t_n} Q={q_n}", ms,
                              plain, n_bytes, n_ops, "float64", err)
        dev_ms = device_ms_per_call(
            f"fused_masked_scan Q={q_n}", lambda: fms.fused_masked_scan(*args))
        records[q_n]["device_ms"] = dev_ms
        # The instruction floor: the stage loop's instructions a tuple, for
        # every warp with a live snippet, over 4 schedulers an SM issuing
        # one instruction a clock each.
        floor, each = None, per_tuple[plan.spl]
        if each is not None:
            warps = -(-q_n // (32 * plan.spl))  # live warps a chunk
            floor = each * t_n * warps / (n_sm * 4 * clock) * 1e3
            log(f"  fused_masked_scan Q={q_n}: instruction floor {floor:.6f} "
                f"ms ({each:.3f} instructions a tuple a warp x {t_n} tuples "
                f"x {warps} warps a chunk / ({n_sm} SMs x 4 schedulers x "
                f"{clock / 1e9:.3f} GHz); {floor / ms:.4f} of the CUDA-event "
                "time" + (f", {floor / dev_ms:.4f} of the device time"
                          if dev_ms else ""))
        records[q_n]["instruction_floor_ms"] = floor
    assert torch.equal(outs[4096][:128], outs[128]), (
        "K1's rows differ between Q = 128 and Q = 4096")
    log("  rows 0..127 of the Q = 4096 launch are bitwise the Q = 128 launch")
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
            dev_ms = device_ms_per_call(
                f"gp_batch_infer Q={q} {name}",
                lambda: gp.gp_batch_infer(*argd, dtype=dt))
            records[(q, name)]["device_ms"] = dev_ms
            if dev_ms:
                log(f"  gp_batch_infer Q={q} C={c} {name}: CUDA events "
                    f"{ms:.6f} ms, device {dev_ms:.6f} ms; achieved "
                    f"{n_bytes / dev_ms / 1e9:.4f} TB/s and "
                    f"{n_ops / dev_ms / 1e9:.4f} TFLOP/s (device time); "
                    f"device share of bound "
                    f"{records[(q, name)]['bound_ms'] / dev_ms:.4f}")
    # A fill of 600 padded (Σ⁻¹ = I, k = 0, α = 0) to its own bucket and
    # to C = 2000, as a fill floor of 2048 pads it: told the fill, the
    # kernel covers the bucket alone at both Cs, bitwise.
    live, q = 600, 8
    rng = np.random.default_rng(seed + live)
    a = rng.normal(size=(live, live))
    base = (rng.normal(0, 0.1, (q, live)), a @ a.T / live + np.eye(live),
            rng.normal(0, 1, (live,)))
    tail = (rng.uniform(0.5, 1.0, q), rng.normal(0, 1, (q,)),
            rng.normal(0, 1, (q,)), rng.uniform(0.0, 0.3, (q,)))
    padded, times = {}, {}
    for cp in (1024, c):
        k = np.concatenate([base[0], np.zeros((q, cp - live))], 1)
        sinv = np.eye(cp)
        sinv[:live, :live] = base[1]
        alpha = np.concatenate([base[2], np.zeros(cp - live)])
        args = [torch.as_tensor(v, dtype=torch.float64, device=dev)
                for v in (k, sinv, alpha) + tail]
        padded[cp] = gp.gp_batch_infer(*args, live=live)
        times[cp] = time_ms(lambda: gp.gp_batch_infer(*args, live=live),
                            inner=10)
    assert all(torch.equal(g, h) for g, h in zip(padded[1024], padded[c]))
    log(f"  gp_batch_infer Q={q}, a fill of {live} padded to C=1024 and to "
        f"C={c}: bitwise; {times[1024]:.6f} / {times[c]:.6f} ms (CUDA "
        "events, wrapper included)")
    records["padded"] = times
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
        dev_ms = device_ms_per_call(
            f"masked_partials Q={q_n}", lambda: fms.masked_partials(mask, meas))
        records[q_n]["device_ms"] = dev_ms
        lib_dev = device_ms_per_call(f"mask.T @ payload Q={q_n}",
                                     lambda: mask.T @ payload)
        # The C entry point alone, on preallocated buffers: the CUDA-event
        # time without the Python wrapper's host work.
        out_e = torch.empty((q_n, p), dtype=torch.float64, device=rel.device)
        scr_e = torch.empty(fms.masked_partials_plan(t_n, q_n, m).scratch,
                            dtype=torch.float64, device=rel.device)
        entry, stream = fms._entry("mpa_launch"), torch.cuda.current_stream()
        entry_ms = time_ms(lambda: entry(
            mask.data_ptr(), meas.data_ptr(), m, t_n, q_n, m, 0, m,
            fms.FMS_CHUNK_T, scr_e.data_ptr(), out_e.data_ptr(),
            stream.cuda_stream), inner=10)
        assert torch.equal(out_e, got), "K4's entry point differs"
        records[q_n]["entry_ms"] = entry_ms
        log(f"  masked_partials Q={q_n}: entry point alone {entry_ms:.6f} ms "
            f"(CUDA events), {entry_ms / lib:.4f} of mask.T @ payload")
        log(f"  masked_partials Q={q_n}: kernel / mask.T @ payload = "
            f"{ms / lib:.4f} in CUDA-event time (same run)"
            + (f", {dev_ms / lib_dev:.4f} in device time; achieved "
               f"{n_bytes / dev_ms / 1e9:.4f} TB/s, device share of bound "
               f"{records[q_n]['bound_ms'] / dev_ms:.4f}"
               if dev_ms and lib_dev else ""))
        del mask
    return records


def check_k5(rel, seed):
    """K5 on one SF1 sample batch's block at Q = 128: P = 5 (the [m, m^2,
    1] payload of the relation's 2 measures) and P = WIDE_P (of 17 measures
    made from them, one launch). Count exact, sums rtol 1e-5, bitwise on a
    repeat, one launch a call, and at P = WIDE_P every column bitwise the
    kernel on it alone. Returns {P: record}."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.range_mask_agg import ops as rma
    from repro_torch.kernels.range_mask_agg.ref import range_mask_agg_ref

    log(f"-- K5 range_mask_agg (f32) at P = 5 and P = {WIDE_P}: count exact, "
        "sums/sumsq rtol 1e-5, repeat bitwise, one launch a call, every "
        "column bitwise the kernel on it alone")
    rows = np.random.default_rng(seed + 8).permutation(rel.cardinality)
    blk = rel.take(rows[:SF1_BATCH_T])
    f32 = torch.float32
    x = blk.num_normalized.to(f32)
    meas = blk.measures.to(f32)
    m17 = meas[:, :1].repeat(1, 17) + torch.arange(17, device=rel.device)
    t_n, l = x.shape
    q_n = 128
    s = _fused_snippets(rel, seed, 2000, q_n).to(rel.device)
    lo, hi = s.lo.to(f32), s.hi.to(f32)
    extra = rma.categorical_premask(blk.cat, s.cat)
    records = {}
    for m in (meas, m17):
        payload = torch.cat([m, m * m, m.new_ones((t_n, 1))], 1)
        p = payload.shape[1]
        args = (x, payload, lo, hi, extra)
        before = launch_counts()["range_mask_agg"]
        got = rma.range_mask_agg(*args)
        assert launch_counts()["range_mask_agg"] == before + 1
        again = rma.range_mask_agg(*args)
        want = range_mask_agg_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "K5 is not bitwise across runs"
        assert torch.equal(got[:, -1], want[:, -1]), "K5 count differs"
        assert torch.allclose(got[:, :-1], want[:, :-1], rtol=1e-5,
                              atol=0.0), float(
            ((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        if p == WIDE_P:
            for j in range(p):
                alone = rma.range_mask_agg(x, payload[:, j:j + 1].contiguous(),
                                           lo, hi, extra)
                assert torch.equal(got[:, j:j + 1], alone), f"K5 column {j}"
        plan = rma.range_mask_agg_plan(t_n, q_n, l, p)
        log(f"  range_mask_agg P={p}: one launch, {plan.groups} column "
            f"group(s) of {plan.group_width}, {plan.blocks} blocks of "
            f"{plan.tiles} snippet tiles x {plan.groups_a_block} group(s), "
            f"{plan.smem} B of shared memory a block")
        err = float((got - want).abs().max())
        ms = time_ms(lambda: rma.range_mask_agg(*args), inner=10)
        plain = time_ms(lambda: range_mask_agg_ref(*args))
        n_bytes = 4 * (t_n * l + t_n * p + 2 * q_n * l + t_n * q_n + q_n * p)
        n_ops = t_n * q_n * (2 * l + 2 * p)
        rec = report("range_mask_agg", f"T={t_n} Q={q_n} P={p}", ms, plain,
                     n_bytes, n_ops, "float32", err)
        rec["device_ms"] = dev_ms = device_ms_per_call(
            f"range_mask_agg P={p}", lambda: rma.range_mask_agg(*args))
        rec["launches_a_call"] = 1
        if dev_ms:
            log(f"  range_mask_agg P={p}: device {dev_ms:.6f} ms, device "
                f"share of bound {rec['bound_ms'] / dev_ms:.4f}, achieved "
                f"{n_bytes / dev_ms / 1e9:.4f} TB/s")
        records[p] = rec
    log("  every column at P=%d bitwise the kernel on that column alone; "
        "library_ms is null for range_mask_agg: no single PyTorch call "
        "computes range compares times a mask folded against a payload"
        % WIDE_P)
    return records


GD_T = 599_861  # the first sample batch at TPC-H SF10 (the benchmark's cell)
GD_CATS = (3, 2, 25)  # returnflag, linestatus, nation


def _k6_inputs(n_probes, seed):
    """The SF10 cell's first batch (3 numeric dims; returnflag, linestatus,
    nation) on the card and ``n_probes`` COUNT probes over a window of the
    first dim, grouped by returnflag (the cell's group-by template), one in
    four by all three columns."""
    import torch
    from repro_torch.aqp import queries as Q
    from repro_torch.core.types import Schema, SnippetBatch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (GD_T, 3)), device="cuda")
    codes = torch.as_tensor(np.stack(
        [rng.integers(0, s, GD_T) for s in GD_CATS], 1).astype(np.int32),
        device="cuda")
    schema = Schema((0.0,) * 3, (1.0,) * 3, GD_CATS, 1)
    snips, groupby = [], []
    for p in range(n_probes):
        a = rng.uniform(0, 0.8)
        q = Q.AggQuery(aggs=(Q.AggSpec("COUNT"),), predicates=(
            Q.NumRange(0, a, a + rng.uniform(0.035, 0.16)),))
        snips.append(Q.decompose(schema, q).snippets)
        groupby.append((0, 1, 2) if p % 4 == 3 else (0,))
    return x, codes, SnippetBatch.concat(snips), groupby


def _kernel_device_ms(fn, name, n=10, windows=3):
    """The profiler's device time a launch of the kernels whose name holds
    ``name``: the median over ``windows`` windows of ``n`` calls of the
    mean over the launches each recorded; None where none recorded it."""
    per = []
    for _ in range(windows):
        _, _, rec = device_profile(fn, n)
        hit = [v for k, v in rec.items() if name in k]
        if hit:
            per.append(1e3 * sum(v[1] for v in hit) / sum(v[0] for v in hit))
    return float(np.median(per)) if per else None


def check_k6(seed):
    """K6 at the SF10 cell's shape (599,861 tuples) with 1 and 16 probes,
    on the table route (the bound as shipped) and the sorted route (the
    bound cut to 0): presence and keys bitwise the plain version on the
    card and bitwise on a repeat, one launch a call, the groups equal to
    discovery on the CPU. Returns {(probes, route): record}."""
    import torch
    from repro_torch.core.engine import discover_groups
    from repro_torch.kernels import RANGE_EPS, launch_counts
    from repro_torch.kernels.group_discovery import ops as gd_ops
    from repro_torch.kernels.group_discovery.ref import group_discovery_ref

    log(f"-- K6 group_discovery (f64) at T={GD_T}, 1 and 16 probes, table "
        "and sorted routes: presence and keys bitwise the plain version and "
        "a repeat, one launch a call, groups equal to the CPU's")
    shipped = gd_ops.GD_TABLE_KEYS
    records = {}
    for n in (1, 16):
        x, codes, probes, groupby = _k6_inputs(n, seed + 31 + n)
        lo = (probes.lo - RANGE_EPS).cuda()
        hi = (probes.hi + RANGE_EPS).cuda()
        member = probes.cat.cuda()
        for route, bound in (("table", shipped), ("sorted", 0)):
            gd_ops.GD_TABLE_KEYS = bound
            try:
                plan = gd_ops.discovery_plan(groupby, GD_CATS)
                groups = discover_groups(x, codes, probes, groupby, GD_CATS)
                want_groups = discover_groups(x.cpu(), codes.cpu(), probes,
                                              groupby, GD_CATS)
            finally:
                gd_ops.GD_TABLE_KEYS = shipped
            assert (plan.n_rows == 0) == (route == "table"), plan
            assert groups == want_groups, f"K6 {route} P={n}: groups differ"
            assert all(groups), "every probe admits some tuple"
            meta = [torch.as_tensor(a, device="cuda")
                    for a in (plan.gcol, plan.gstride, plan.route)]

            def kernel():
                return gd_ops.group_discovery(x, codes, lo, hi, member, plan)

            def plain():
                return group_discovery_ref(x, codes, lo, hi, member, *meta,
                                           plan.n_keys, plan.n_rows)

            before = launch_counts()["group_discovery"]
            got = kernel()
            assert launch_counts()["group_discovery"] == before + 1
            again, want = kernel(), plain()
            torch.cuda.synchronize()
            for name, g, a, w in zip(("presence", "keys"), got, again, want):
                assert torch.equal(g, w), f"K6 {route} P={n}: {name} differs"
                assert torch.equal(a, w), f"K6 {route} P={n}: {name} repeat"
            ms = time_ms(kernel, inner=10)
            plain_ms = time_ms(plain, reps=5)
            # Read once: the batch, the probes' bounds and sets, the plan;
            # written once: the presence table and the sorted keys.
            n_bytes = (x.numel() * 8 + codes.numel() * 4 + 2 * lo.numel() * 8
                       + member.numel() + sum(m.numel() * 8 for m in meta)
                       + plan.n_keys + plan.n_rows * GD_T * 8)
            l, c, g = x.shape[1], codes.shape[1], plan.gcol.shape[1]
            n_ops = GD_T * n * (2 * l + c + 2 * g)
            rec = report("group_discovery", f"T={GD_T} P={n} {route}", ms,
                         plain_ms, n_bytes, n_ops, "float64", 0.0)
            rec["device_ms"] = dev = _kernel_device_ms(kernel, "gd_mark")
            rec["launches_a_call"] = 1
            t_host = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gd_ops.GD_TABLE_KEYS = bound
                try:
                    discover_groups(x, codes, probes, groupby, GD_CATS)
                finally:
                    gd_ops.GD_TABLE_KEYS = shipped
                t_host.append(1e3 * (time.perf_counter() - t0))
            rec["discover_ms"] = float(np.median(t_host))
            log(f"  group_discovery P={n} {route}: key space {plan.n_keys}, "
                f"sorted rows {plan.n_rows}; gd_mark device "
                + ("not measured" if dev is None else
                   f"{dev:.6f} ms, device share of bound "
                   f"{rec['bound_ms'] / dev:.4f}")
                + f"; a flush's whole discovery (host clock, launch, "
                f"sort-unique, one copy, decode) {rec['discover_ms']:.6f} ms")
            records[(n, route)] = rec
    log("  library_ms is null for group_discovery: no single PyTorch call "
        "marks group codes under range and membership tests")
    return records


WIDE_M = 12  # measures of phase 2's wide K1 / K4 shape (two launches)
WIDE_P = 35  # payload columns of the wide K5 shape (one launch)
WIDE_L = 12  # numeric dims of the wide K3 shapes (the kernels for any l)
WIDE_REL = dict(n_num=9, n_measures=9)  # phase 4's wide relation


def check_wide(rel, seed):
    """Phase 2 past the widths one launch takes: K1 and K4 at 12 measures,
    K1's kernel for any width on phase 4's wide relation, K3 at l = 12, at
    the main path's T and Q (K5's wide shape is check_k5's)."""
    import torch
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import (
        fused_masked_scan_ref, masked_partials_ref)
    from repro_torch.aqp.executor import predicate_mask

    log(f"-- wide shapes: K1 and K4 at M={WIDE_M} (count exact, rtol 1e-11, "
        "K4 bitwise K1, every measure's columns and the count bitwise the "
        f"kernels on that measure alone), K3 at l={WIDE_L} under its three "
        "bitwise contracts")
    dev = rel.device
    rng = np.random.default_rng(seed + 21)
    rows = rng.permutation(rel.cardinality)[:60_000]
    blk = rel.take(rows)
    x, codes = blk.num_normalized, blk.cat
    t_n, l = x.shape
    c = codes.shape[1]
    meas = torch.as_tensor(rng.normal(1.0, 2.0, (t_n, WIDE_M)), device=dev)
    s = _fused_snippets(rel, seed, 2000, 128).to(dev)
    q_n, v = 128, s.cat.shape[2]
    args = (x, codes, meas, s.lo, s.hi, s.cat)
    got = fms.fused_masked_scan(*args)
    want = fused_masked_scan_ref(x, codes, None, meas, s.lo, s.hi, s.cat)
    mask = predicate_mask(x, codes, s)
    k4 = fms.masked_partials(mask, meas)
    torch.cuda.synchronize()
    assert torch.equal(got, fms.fused_masked_scan(*args))
    assert torch.equal(got[:, -1], want[:, -1])
    assert torch.allclose(got, want, rtol=1e-11, atol=0.0)
    assert torch.equal(k4, got), "K4 at M=12 is not K1's bits"
    for j in range(WIDE_M):
        one = meas[:, j:j + 1].contiguous()
        alone = fms.fused_masked_scan(x, codes, one, s.lo, s.hi, s.cat)
        cols = [j, WIDE_M + j, 2 * WIDE_M]
        assert torch.equal(got[:, cols], alone), f"K1 measure {j}"
        assert torch.equal(fms.masked_partials(mask, one), alone), (
            f"K4 measure {j}")
    log(f"  K1 and K4 at M={WIDE_M}: {len(fms.measure_groups(WIDE_M))} "
        "launches each; K4 bitwise K1; every measure column and the count "
        "bitwise the kernels on that measure alone")
    records = {}
    p = 2 * WIDE_M + 1
    records["k1"] = report(
        "fused_masked_scan", f"T={t_n} Q={q_n} M={WIDE_M}",
        time_ms(lambda: fms.fused_masked_scan(*args), inner=10),
        time_ms(lambda: fused_masked_scan_ref(x, codes, None, meas, s.lo,
                                              s.hi, s.cat), reps=10),
        t_n * (8 * l + 4 * c + 8 * WIDE_M) + q_n * (16 * l + c * v)
        + q_n * p * 8, t_n * q_n * (2 * l + c + 2 * p), "float64",
        float((got - want).abs().max()))
    records["k1"]["device_ms"] = device_ms_per_call(
        f"fused_masked_scan M={WIDE_M}", lambda: fms.fused_masked_scan(*args),
        launches={"mpa_fold": len(fms.measure_groups(WIDE_M))})
    payload = torch.cat([meas, meas * meas, meas.new_ones((t_n, 1))], 1)
    records["k4"] = report(
        "masked_partials", f"T={t_n} Q={q_n} M={WIDE_M}",
        time_ms(lambda: fms.masked_partials(mask, meas), inner=10),
        time_ms(lambda: masked_partials_ref(mask, meas), reps=10),
        8 * (t_n * q_n + t_n * WIDE_M + q_n * p), 2 * t_n * q_n * p,
        "float64", float((k4 - want).abs().max()),
        library_ms=time_ms(lambda: mask.T @ payload, inner=10))
    records["k4"]["device_ms"] = device_ms_per_call(
        f"masked_partials M={WIDE_M}", lambda: fms.masked_partials(mask, meas),
        launches={"mpa_fold": len(fms.measure_groups(WIDE_M))})
    del mask
    records.update(check_k1_any(rel, seed))
    records.update(check_k3_wide(seed, dev))
    return records


def _pad_neutral(x, codes, lo, hi, cat, n_num, v):
    """A block and its snippets with numeric dims up to ``n_num`` (x = 0
    against [-inf, inf]) and one more categorical dim of ``v`` values
    (every tuple's code 0, every snippet's set full), the other dims' sets
    widened to ``v`` values with no member past their own: the same
    predicate on a shape K1's registers do not take."""
    import torch

    t_n, l = x.shape
    q_n = lo.shape[0]
    inf = torch.full((q_n, n_num - l), float("inf"), dtype=lo.dtype,
                     device=lo.device)
    sets = cat.new_zeros((q_n, cat.shape[1] + 1, v))
    sets[:, :-1, :cat.shape[2]] = cat
    sets[:, -1] = True
    return (torch.cat([x, x.new_zeros((t_n, n_num - l))], 1),
            torch.cat([codes, codes.new_zeros((t_n, 1))], 1).contiguous(),
            torch.cat([lo, -inf], 1), torch.cat([hi, inf], 1), sets)


def check_k1_any(rel, seed):
    """K1's kernel for any width (``fms_partials_any``, path 0) at the shape
    phase 4's wide relation gives it: a 60,000-tuple block of that relation
    (9 numeric dims, 9 measures: two launches, over 8 measures and 1) and
    128 snippets of its warm-up workload. Count exact, rtol 1e-11 against
    the plain version, bitwise on a repeat, K4 bitwise K1; and phase 2's
    main-path block padded with neutral dims to 9 numeric dims and a
    categorical dim of 70 values takes path 0 and gives the register
    path's bits on the unpadded block. The floors from the SASS of its
    tuple loop."""
    import torch
    from repro_torch.aqp.executor import predicate_mask
    from repro_torch.aqp.workload import make_relation, make_workload
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import fused_masked_scan_ref

    dev = rel.device
    # The main path's block (register path), and padded (any width).
    rows = np.random.default_rng(seed + 25).permutation(rel.cardinality)
    nb = rel.take(rows[:60_000])
    ns = _fused_snippets(rel, seed, 2000, 128).to(dev)
    narrow = (nb.num_normalized, nb.cat, nb.measures, ns.lo, ns.hi, ns.cat)
    padded = _pad_neutral(nb.num_normalized, nb.cat, ns.lo, ns.hi, ns.cat,
                          WIDE_REL["n_num"], 70)
    t_n = nb.measures.shape[0]
    m_n = nb.measures.shape[1]
    assert fms.fused_scan_plan(t_n, 128, m_n, nb.num_normalized.shape[1],
                               nb.cat.shape[1], ns.cat.shape[2]).path == 1
    assert fms.fused_scan_plan(t_n, 128, m_n, WIDE_REL["n_num"],
                               padded[1].shape[1], 70).path == 0
    want_n = fms.fused_masked_scan(*narrow)
    got_p = fms.fused_masked_scan(*padded[:2], nb.measures, *padded[2:])
    torch.cuda.synchronize()
    assert float(want_n[:, -1].sum()) > 0
    assert torch.equal(got_p, want_n), (
        "K1 for any width on the padded block is not the register path's "
        "bits")
    log("  K1 for any width on the main path's block padded to "
        f"L={WIDE_REL['n_num']} and a categorical dim of 70 values: path 0, "
        "bitwise the register path on the unpadded block")

    wrel = make_relation(seed + 5, 600_000, **WIDE_REL)
    rows = np.random.default_rng(seed + 24).permutation(wrel.cardinality)
    blk = wrel.take(rows[:60_000])
    x, codes, meas = blk.num_normalized, blk.cat, blk.measures
    t_n, l = x.shape
    c, m = codes.shape[1], meas.shape[1]
    s = _fused_snippets(wrel, seed + 6, 200, 128, make_workload).to(dev)
    q_n, v = 128, s.cat.shape[2]
    plans = [fms.fused_scan_plan(t_n, q_n, count, l, c, v)
             for _, count in fms.measure_groups(m)]
    assert {p.path for p in plans} == {0}, (
        f"the wide block takes K1's paths {[p.path for p in plans]}")
    args = (x, codes, meas, s.lo, s.hi, s.cat)
    got = fms.fused_masked_scan(*args)
    want = fused_masked_scan_ref(x, codes, None, meas, s.lo, s.hi, s.cat)
    k4 = fms.masked_partials(predicate_mask(x, codes, s), meas)
    torch.cuda.synchronize()
    assert torch.equal(got, fms.fused_masked_scan(*args)), (
        "K1 for any width is not bitwise across runs")
    assert torch.equal(got[:, -1], want[:, -1]), "K1 for any width: count"
    assert float(got[:, -1].sum()) > 0
    assert torch.allclose(got, want, rtol=1e-11, atol=0.0), float(
        ((got - want).abs() / want.abs().clamp(min=1e-300)).max())
    assert torch.equal(k4, got), "K4 on the wide block is not K1's bits"
    log(f"  K1 for any width (L={l}, C={c}, V={v}, M={m}: "
        f"{len(plans)} launches of fms_partials_any, "
        + ", ".join(f"{p.blocks} blocks of {p.tile_q // 32} warps with "
                    f"{p.smem} B of shared memory" for p in plans)
        + "): count exact, rtol 1e-11, bitwise on a repeat, K4 bitwise K1")
    p = 2 * m + 1
    rec = report(
        "fms_partials_any", f"T={t_n} Q={q_n} L={l} M={m}",
        time_ms(lambda: fms.fused_masked_scan(*args), inner=10),
        time_ms(lambda: fused_masked_scan_ref(x, codes, None, meas, s.lo,
                                              s.hi, s.cat), reps=10),
        t_n * (8 * l + 4 * c + 8 * m) + q_n * (16 * l + c * v) + q_n * p * 8,
        t_n * q_n * (2 * l + c + 2 * p), "float64",
        float((got - want).abs().max()))
    rec["device_ms"] = dev_ms = device_ms_per_call(
        f"fms_partials_any L={l} M={m}", lambda: fms.fused_masked_scan(*args),
        launches={"mpa_fold": len(plans)})
    # The floors: instructions (4 schedulers an SM, one a clock) and the
    # FP64 pipe (16 lanes a scheduler: two clocks a warp instruction), for
    # every launch's live warps over every tuple.
    clock = max_sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    warps = -(-q_n // 32)
    issue = fp64 = 0.0
    for (_, count), plan in zip(fms.measure_groups(m), plans):
        per, fp, _ = k1_any_sass_count(count, plan.words, plan.rows)
        if per is None:
            issue = fp64 = None
            break
        scale = t_n * warps / (n_sm * 4 * clock) * 1e3
        issue += per * scale
        fp64 += 2 * fp * scale
    rec["instruction_floor_ms"] = issue
    rec["fp64_floor_ms"] = fp64
    if issue is not None:
        floor = max(issue, fp64)
        log(f"  fms_partials_any: instruction floor {issue:.6f} ms, FP64-pipe "
            f"floor {fp64:.6f} ms over both launches ({t_n} tuples x {warps} "
            f"warps a chunk / ({n_sm} SMs x 4 schedulers x "
            f"{clock / 1e9:.3f} GHz))" + (
                f"; the device time reaches {floor / dev_ms:.4f} of the "
                "larger" if dev_ms else ""))
    return {"k1_any": rec, "k1_global": check_k1_global(nb, ns, seed)}


GLOBAL_V = 30_000  # values of the categorical dim that takes K1's path 3
GLOBAL_V_WIDE = 100_000  # ... whose words pass a block's shared memory
GLOBAL_T_SMALL = 3_000  # tuples of the block with that dim


def _with_wide_dim(blk, s, v, rng, t_n=None):
    """The first ``t_n`` tuples of ``blk`` and the snippets ``s`` with one
    more categorical dim of ``v`` values (codes uniform, each snippet's set
    ~70% of them): (x, codes, measures, lo, hi, sets)."""
    import torch

    x, meas = blk.num_normalized[:t_n], blk.measures[:t_n]
    t_n = x.shape[0]
    q_n, c0, v0 = s.cat.shape
    dev = x.device
    extra = torch.as_tensor(rng.integers(0, v, (t_n, 1)),
                            dtype=blk.cat.dtype, device=dev)
    codes = torch.cat([blk.cat[:t_n], extra], 1).contiguous()
    sets = s.cat.new_zeros((q_n, c0 + 1, v))
    sets[:, :-1, :v0] = s.cat
    sets[:, -1] = torch.as_tensor(rng.uniform(size=(q_n, v)) < 0.7,
                                  device=dev)
    return (x.contiguous(), codes, meas.contiguous(), s.lo, s.hi, sets)


def _hold_k1(args, what):
    """K1 against its plain version on ``args``: count exact, rtol 1e-11,
    bitwise on a repeat, K4 bitwise K1. Returns (K1's output, plain)."""
    import torch
    from repro_torch.aqp.executor import snippet_mask
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import fused_masked_scan_ref

    x, codes, meas, lo, hi, sets = args
    got = fms.fused_masked_scan(*args)
    want = fused_masked_scan_ref(x, codes, None, meas, lo, hi, sets)
    k4 = fms.masked_partials(snippet_mask(x, codes, lo, hi, sets), meas)
    torch.cuda.synchronize()
    assert torch.equal(got, fms.fused_masked_scan(*args)), (
        f"{what} is not bitwise across runs")
    assert torch.equal(got[:, -1], want[:, -1]), f"{what}: count"
    assert float(got[:, -1].sum()) > 0
    assert torch.allclose(got, want, rtol=1e-11, atol=0.0), float(
        ((got - want).abs() / want.abs().clamp(min=1e-300)).max())
    assert torch.equal(k4, got), f"K4 on the {what} block is not K1's bits"
    return got, want


def check_k1_global(blk, s, seed):
    """K1's kernel for shapes whose any-width staging outgrows a block's
    shared memory (``fms_partials_stream``, path 3): phase 2's main-path
    block and snippets with one more categorical dim of GLOBAL_V values,
    and its first GLOBAL_T_SMALL tuples with one of GLOBAL_V_WIDE values
    (a tile's category words past a block's shared memory: streamed in
    slices). Count exact, rtol 1e-11 against the plain version, bitwise on
    a repeat, K4 bitwise K1."""
    from repro_torch.kernels.fused_masked_scan import ops as fms
    from repro_torch.kernels.fused_masked_scan.ref import fused_masked_scan_ref

    rng = np.random.default_rng(seed + 26)
    args = _with_wide_dim(blk, s, GLOBAL_V, rng)
    x, codes, meas = args[:3]
    (t_n, l), c, m = x.shape, codes.shape[1], meas.shape[1]
    q_n = s.cat.shape[0]
    plan = fms.fused_scan_plan(t_n, q_n, m, l, c, GLOBAL_V)
    assert plan.path == 3, f"C={c} V={GLOBAL_V} takes K1's path {plan.path}"
    got, want = _hold_k1(args, "fms_partials_stream")
    log(f"  K1 with streamed category words (L={l}, C={c}, V={GLOBAL_V}, "
        f"M={m}: path 3, {plan.blocks} blocks of {plan.chunks_a_block} "
        f"chunks, {plan.smem} B of shared memory, {plan.word_scratch} words "
        "of scratch): count exact, rtol 1e-11, bitwise on a repeat, K4 "
        "bitwise K1")
    small = _with_wide_dim(blk, s, GLOBAL_V_WIDE, rng, GLOBAL_T_SMALL)
    plan_w = fms.fused_scan_plan(GLOBAL_T_SMALL, q_n, m, l, c, GLOBAL_V_WIDE)
    assert plan_w.path == 3 and plan_w.word_scratch * 4 // -(-q_n // 32) > (
        plan_w.smem), plan_w
    _hold_k1(small, "fms_partials_stream (V=100,000)")
    log(f"  ... and on {GLOBAL_T_SMALL} tuples with a dim of "
        f"{GLOBAL_V_WIDE} values (a tile's words {plan_w.word_scratch * 4 // -(-q_n // 32)} B, "
        f"staged {plan_w.smem} B at a time): the same contracts")
    p = 2 * m + 1
    rec = report(
        "fms_partials_stream", f"T={t_n} Q={q_n} C={c} V={GLOBAL_V} M={m}",
        time_ms(lambda: fms.fused_masked_scan(*args), inner=10),
        time_ms(lambda: fused_masked_scan_ref(x, codes, None, meas, *args[3:]),
                reps=5),
        t_n * (8 * l + 4 * c + 8 * m) + q_n * (16 * l + c * GLOBAL_V)
        + q_n * p * 8, t_n * q_n * (2 * l + c + 2 * p), "float64",
        float((got - want).abs().max()))
    rec["device_ms"] = device_ms_per_call(
        f"fms_partials_stream C={c} V={GLOBAL_V}",
        lambda: fms.fused_masked_scan(*args))
    return rec


def check_k3_wide(seed, dev):
    """K3 at l = 12 (the kernels for any l): the general forward at
    improve's shape, bitwise the plain version's per-dimension integrals in
    the kernels' order; the Gram forward at 2000 x 2000, bitwise the general
    kernel; its derivatives bitwise se_cov_derivs_ref, with no device memory
    beyond the outputs; the gradient against autograd of the plain version
    (rtol 1e-9), Gram route bitwise general; the reduction of the
    derivatives. Records with SASS floors (bytes bound for the
    reduction)."""
    import torch
    from repro_torch.kernels.se_covariance import ops as se
    from repro_torch.kernels.se_covariance.ref import (se_cov_derivs_ref,
                                                       se_cov_grad_ref,
                                                       se_cov_matrix_ref)

    l, sigma2, n = WIDE_L, 1.7, SYNOPSIS_C
    rng = np.random.default_rng(seed + 23)
    ls = torch.as_tensor(rng.uniform(0.3, 1.5, l), device=dev)
    lo_i, hi_i = (torch.as_tensor(a, device=dev) for a in _se_inputs(rng, 128,
                                                                      l))
    lo, hi = (torch.as_tensor(a, device=dev) for a in _se_inputs(rng, n, l))
    ni = torch.as_tensor(rng.uniform(0.5, 2.0, 128), device=dev)
    nj = torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev)
    gen = (lo_i, hi_i, lo, hi, ls, sigma2, ni, nj)
    got = se.se_cov_matrix(*gen)
    want = se_cov_matrix_ref(*gen)
    torch.cuda.synchronize()
    assert torch.equal(got, se.se_cov_matrix(*gen))
    assert torch.allclose(got, want, rtol=1e-12, atol=0.0), _rel(got, want)
    assert torch.equal(got, _k3_seq(gen, l)), (
        "K3 at l=12 differs from the plain per-dimension integrals")
    records = {}
    records["k3_general"] = report(
        "se_cov_matrix", f"128x{n} l={l} float64",
        time_ms(lambda: se.se_cov_matrix(*gen), inner=10),
        time_ms(lambda: se_cov_matrix_ref(*gen), reps=10),
        8 * (2 * (128 + n) * l + l + 128 + n + 1 + 128 * n),
        _k3_ops(128, n, l)["general"], "float64_simt",
        float((got - want).abs().max()))
    records["k3_general"]["device_ms"] = device_ms_per_call(
        f"se_cov_matrix 128x{n} l={l}", lambda: se.se_cov_matrix(*gen))
    full = (lo, hi, lo, hi, ls, sigma2, nj, nj)
    gram = se.se_cov_gram(lo, hi, ls, sigma2, nj)
    want_n = se_cov_matrix_ref(*full)
    assert torch.equal(gram, se.se_cov_matrix(*full)), (
        "K3 Gram at l=12 is not the general kernel's bits")
    records["k3_gram"] = report(
        "se_cov_gram", f"{n}x{n} l={l} float64",
        time_ms(lambda: se.se_cov_gram(lo, hi, ls, sigma2, nj), inner=3),
        time_ms(lambda: se_cov_matrix_ref(*full), reps=3),
        8 * (2 * n * l + l + n + 1 + n * n), _k3_ops(n, n, l)["gram"],
        "float64_simt", float((gram - want_n).abs().max()))
    records["k3_gram"]["device_ms"] = device_ms_per_call(
        f"se_cov_gram {n}x{n} l={l}",
        lambda: se.se_cov_gram(lo, hi, ls, sigma2, nj))
    del want_n
    # Device memory a Gram call with derivatives takes: its outputs only
    # (an earlier form of the kernels for any l took an (l, n, n) scratch).
    out_bytes = 8 * (1 + l) * n * n
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k_g, d_g = se.se_cov_gram_derivs(lo, hi, ls, sigma2, nj)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= out_bytes + (1 << 20), (peak, out_bytes)
    log(f"  se_cov_gram_derivs {n}x{n} l={l}: peak {peak / 1e6:.3f} MB "
        f"allocated for the call, its outputs {out_bytes / 1e6:.3f} MB; no "
        f"(l, n, n) scratch ({8 * l * n * n / 1e6:.3f} MB)")
    _, want_d = se_cov_derivs_ref(*full)
    torch.cuda.synchronize()
    assert torch.equal(k_g, gram)
    assert torch.equal(d_g, want_d), (
        f"K3 D at l=12 differs from se_cov_derivs_ref in "
        f"{int((d_g != want_d).sum())} of {d_g.numel()}")
    del want_d
    records["k3_derivs"] = report(
        "se_cov_derivs", f"{n}x{n} l={l} float64 Gram",
        time_ms(lambda: se.se_cov_gram_derivs(lo, hi, ls, sigma2, nj),
                inner=3),
        time_ms(lambda: se_cov_derivs_ref(*full), reps=3),
        8 * (2 * n * l + l + n + 1 + (1 + l) * n * n), _k3_ops(n, n, l)[
            "derivs"], "float64_simt", 0.0)
    records["k3_derivs"]["device_ms"] = device_ms_per_call(
        f"se_cov_derivs {n}x{n} l={l}",
        lambda: se.se_cov_gram_derivs(lo, hi, ls, sigma2, nj))
    records["k3_derivs"]["peak_mb"] = peak / 1e6
    records["k3_derivs"]["scratch_mb_dropped"] = 8 * l * n * n / 1e6
    g_out = torch.as_tensor(rng.normal(size=(n, n)), device=dev)
    z = ls.clone().requires_grad_(True)
    (via,) = torch.autograd.grad(se.se_cov_gram(lo, hi, z, sigma2, nj), z,
                                 g_out)
    want_g = se_cov_grad_ref(*full, g_out)
    assert torch.equal(via, se.se_cov_grad(*full, g_out))
    assert torch.allclose(via, want_g, rtol=1e-9, atol=0.0), (via, want_g)
    # The reduction for any l alone, on the Gram call's derivatives.
    red = se._launch_reduce(g_out, d_g)
    assert torch.equal(red, via)
    want_r = (g_out[None] * d_g).sum((1, 2))
    records["k3_reduce"] = report(
        "se_cov_grad", f"{n}x{n} l={l} float64 (reduction)",
        time_ms(lambda: se._launch_reduce(g_out, d_g), inner=10),
        time_ms(lambda: (g_out[None] * d_g).sum((1, 2)), reps=10),
        8 * ((1 + l) * n * n + l), _k3_ops(n, n, l)["reduce"], "float64",
        float((red - want_r).abs().max()))
    records["k3_reduce"]["device_ms"] = device_ms_per_call(
        f"se_cov_grad {n}x{n} l={l}", lambda: se._launch_reduce(g_out, d_g))
    del d_g
    # The floors from the FP64-pipe instructions of one antiderivative
    # (phase 2's K3 count; the kernels for any l evaluate the same one).
    per_anti = k3_sass_counts()
    for key, antiderivs, derivs in (("k3_general", 4 * l * 128 * n, False),
                                    ("k3_gram", 4 * l * n * (n + 1) // 2,
                                     False),
                                    ("k3_derivs", 4 * l * n * (n + 1) // 2,
                                     True)):
        c = per_anti[1 if derivs else 0]
        rec = records[key]
        rec["sass_bound_ms"] = floor = (
            None if c is None else c * antiderivs / FP64_PIPE_LANES_PER_S * 1e3)
        if floor is not None:
            log(f"  {key} l={l}: SASS-count floor {floor:.6f} ms ({c} "
                f"FP64-pipe instructions x {antiderivs} antiderivatives / "
                f"{FP64_PIPE_LANES_PER_S:.3g} a s)" + (
                    f"; the device time reaches {floor / rec['device_ms']:.4f}"
                    " of it" if rec.get("device_ms") else ""))
    log(f"  K3 at l={l}: general 128x{n} bitwise the plain per-dimension "
        "integrals in the kernels' order; Gram bitwise general; D bitwise "
        f"se_cov_derivs_ref; gradient within {_rel(via, want_g):.3e} of "
        "autograd of the plain version, Gram route bitwise general")
    return records


# Ragged shapes checked beside those phase 4 launched: tiles with rows
# past n (the Gram kernel's tiles of 8, the general kernel's 8 x 32 blocks)
# at l = 9 and at 13 (past the 12 dims staged, and derivative chains kept,
# in one pass).
K3_RAGGED = [(route, n_i, n_j, l) for l in (9, 13) for route, n_i, n_j in (
    ("general", 13, 129), ("general+derivs", 13, 129), ("gram", 1, 1),
    ("gram", 21, 21), ("gram", 129, 129), ("gram+derivs", 1, 1),
    ("gram+derivs", 21, 21), ("gram+derivs", 129, 129))]


def check_k3_shapes(shapes, dev, top=3):
    """K3's any-l routes at every (route, n_i, n_j, l) a run launched
    (``shapes``, a Counter) and at K3_RAGGED, on random ranges, each held
    to check_k3_wide's contracts: general bitwise the plain per-dimension
    integrals in the kernels' order and within rtol 1e-12 of
    se_cov_matrix_ref; a Gram matrix bitwise the general kernel on the same
    inputs; D bitwise se_cov_derivs_ref, its K bitwise the forward without
    derivatives. Then the ``top`` most launched shapes of each route are
    timed (CUDA events, and the profiler's device time, which misses some
    of these ~10 us launches)."""
    import torch
    from repro_torch.kernels.se_covariance import ops as se
    from repro_torch.kernels.se_covariance.ref import (se_cov_derivs_ref,
                                                       se_cov_matrix_ref)

    rng = np.random.default_rng(len(shapes))
    calls = {}
    for key in sorted(set(shapes) | set(K3_RAGGED)):
        route, n_i, n_j, l = key
        general_route = route.startswith("general")
        a = [torch.as_tensor(x, device=dev) for x in _se_inputs(rng, n_i, l)]
        b = ([torch.as_tensor(x, device=dev) for x in _se_inputs(rng, n_j, l)]
             if general_route else a)
        ls = torch.as_tensor(rng.uniform(0.3, 1.5, l), device=dev)
        na = torch.as_tensor(rng.uniform(0.5, 2.0, n_i), device=dev)
        nb = (torch.as_tensor(rng.uniform(0.5, 2.0, n_j), device=dev)
              if general_route else na)
        full = (*a, *b, ls, 1.7, na, nb)
        general = se.se_cov_matrix(*full)
        want = se_cov_matrix_ref(*full)
        torch.cuda.synchronize()
        assert torch.equal(general, _k3_seq(full, l)), (
            f"K3 {key}: the general kernel differs from the plain "
            "per-dimension integrals")
        assert torch.allclose(general, want, rtol=1e-12, atol=0.0), (
            key, _rel(general, want))
        if route == "general":
            fn = functools.partial(se.se_cov_matrix, *full)
        elif route == "gram":
            fn = functools.partial(se.se_cov_gram, *a, ls, 1.7, na)
            assert torch.equal(fn(), general), (
                f"K3 {key}: Gram is not the general kernel's bits")
        else:
            fn = (functools.partial(se.se_cov_derivs, *full) if general_route
                  else functools.partial(se.se_cov_gram_derivs, *a, ls, 1.7,
                                         na))
            k, d = fn()
            _, want_d = se_cov_derivs_ref(*full)
            torch.cuda.synchronize()
            assert torch.equal(k, general), (
                f"K3 {key}: K with derivatives differs from the general "
                "kernel's")
            assert torch.equal(d, want_d), (
                f"K3 {key}: D differs from se_cov_derivs_ref in "
                f"{int((d != want_d).sum())} of {d.numel()}")
        calls[key] = fn
    log(f"  K3 for any l held at {len(calls)} shapes ({len(shapes)} launched "
        f"in phase 4, {len(K3_RAGGED)} ragged): general bitwise the plain "
        "per-dimension integrals and within rtol 1e-12 of se_cov_matrix_ref, "
        "Gram bitwise general, D bitwise se_cov_derivs_ref")
    out = {}
    for route in ("general", "general+derivs", "gram", "gram+derivs"):
        mine = [(k, c) for k, c in shapes.most_common() if k[0] == route]
        for key, count in mine[:top]:
            _, n_i, n_j, l = key
            label = f"{route} {n_i}x{n_j} l={l} ({count} launches)"
            ms = time_ms(calls[key], reps=10, inner=10)
            log(f"  {label}: {ms:.6f} ms a call in CUDA events")
            out[f"{route} {n_i}x{n_j} l={l}"] = {
                "launches": count, "ms": ms,
                "device_ms": device_ms_per_call(label, calls[key], n=20)}
    return out


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
    """Operations of K3's calls, from the shapes. Every add, subtract,
    multiply, divide, compare, exp and erf counts as one operation
    (libdevice's exp and erf are tens of instructions each, so this is a
    lower bound on the card's work). An antiderivative is 9 (difference,
    u/z, square, exp, ((-z/2) z) e, ((sqrt(pi)/2) z) u, erf, its product,
    subtract), 13 with dF/dz. An entry is 5 a dimension (3 for the
    inclusion-exclusion, clamp, product) and 3 for the sigma2 and norm
    scale; with derivatives 9 a dimension (both inclusion-exclusions,
    clamp, its mask, product), 4 for the scales and l (l + 1) for the
    products over the other dims. The general kernel evaluates 4 l
    antiderivatives an entry; the Gram kernel (n_i = n_j = n) 4 l a pair
    of the n (n + 1) / 2 this run's data needs. The reduction: a multiply
    and an add for each of the l n_i n_j derivatives."""
    pairs = n_i * n_j
    gram_pairs = n_i * (n_i + 1) // 2
    return {"general": pairs * (4 * 9 * l + 5 * l + 3),
            "gram": gram_pairs * 4 * 9 * l + pairs * (5 * l + 3),
            "derivs": (gram_pairs * 4 * 13 * l
                       + pairs * (9 * l + 4 + l * (l + 1))),
            "reduce": 2 * l * pairs}


# The H100 SXM data sheet's non-tensor FP64 rate, 34 TFLOP/s, is 17.0e12
# DFMA lanes a second: one FP64-pipe instruction a lane each.
FP64_PIPE_LANES_PER_S = 17.0e12
SASS_FP64_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET")


def sass_fp64_paths(lines):
    """FP64-pipe instructions (``SASS_FP64_OPS``) in one kernel's
    ``cuobjdump -sass`` listing: (static count, the fewest and the most on
    a path from the entry that stores to global memory, calls into
    subroutines included, {opcode: static count}). The path counts are None
    where the control flow has a cycle or a jump this parser does not
    follow."""
    import re

    ins, labels = [], {}  # labels: a label or an address -> instruction
    for line in lines:
        m = re.match(r"\s*([.\w$]+):\s*$", line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            labels[int(m.group(1), 16)] = len(ins)
            tgt = re.search(r"`\(([^)]+)\)|\b0x([0-9a-f]+)\s*$", m.group(4))
            if tgt:
                tgt = tgt.group(1) or int(tgt.group(2), 16)
            ins.append((m.group(3).split(".")[0], bool(m.group(2)), tgt))
    ops = {}
    for op, _, _ in ins:
        if op in SASS_FP64_OPS:
            ops[op] = ops.get(op, 0) + 1
    static = sum(ops.values())
    inf = float("inf")

    class Unfollowed(Exception):
        pass

    memo, active = {}, set()

    def best(i, state):
        """(fewest, most) FP64 instructions from instruction i to the end
        of a path: state 0 an EXIT with a store still to come, 1 an EXIT,
        2 a RET (a subroutine's end); (inf, -inf) where none is reached."""
        if i >= len(ins):
            return inf, -inf
        key = (i, state)
        if key in memo:
            return memo[key]
        if key in active:
            raise Unfollowed
        active.add(key)
        op, pred, tgt = ins[i]
        nxt = 1 if state == 0 and op == "STG" else state
        succ, done, extra = [i + 1], False, (0, 0)
        if op in ("BRX", "JMX", "JMP") or (op == "CALL" and pred):
            raise Unfollowed
        if op in ("BRA", "CALL"):
            t = labels.get(tgt)
            if t is None:
                raise Unfollowed
            if op == "CALL":
                extra = best(t, 2)
                if extra[0] == inf:
                    raise Unfollowed
            elif t == i:  # a closing self-loop: a dead end
                succ = []
            else:
                succ = [t, i + 1] if pred else [t]
        elif op in ("EXIT", "RET"):
            done = nxt == (1 if op == "EXIT" else 2)
            succ = [i + 1] if pred else []
        found = [best(s, nxt) for s in succ] + ([(0, 0)] if done else [])
        lo = min((f[0] for f in found), default=inf)
        hi = max((f[1] for f in found), default=-inf)
        cost = int(op in SASS_FP64_OPS)
        res = ((cost + extra[0] + lo, cost + extra[1] + hi) if lo < inf
               else (inf, -inf))
        active.discard(key)
        memo[key] = res
        return res

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20 * len(ins) + 1000))
    try:
        fewest, most = best(0, 0)
    except Unfollowed:
        return static, None, None, ops
    finally:
        sys.setrecursionlimit(limit)
    if fewest == inf:
        return static, None, None, ops
    return static, fewest, most, ops


@functools.lru_cache(maxsize=None)
def k3_sass_counts():
    """FP64-pipe instructions of one antiderivative in the built K3
    library, (F alone, F with dF/dz): each the fewest on a storing path of
    the probe kernel (``se_cov_probe<double, ...>``, the kernels' own
    antiderivative), less the probe's 3 multiplies that form (-z/2) z and
    (sqrt(pi)/2) z (the kernels stage those once a block). (None, None)
    where cuobjdump or the parse fails: the SASS-count bound is then not
    measured."""
    import re

    from repro_torch import kernels

    try:
        tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
        text = subprocess.run(
            [tool, "-sass", str(kernels.library_path("se_covariance"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log(f"  cuobjdump -sass failed ({e}): SASS-count bound not measured")
        return None, None
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    counts = []
    for flag, what in (("0", "F"), ("1", "F and dF/dz")):
        name = next((k for k in funcs if f"se_cov_probeIdLb{flag}E" in k),
                    None)
        if name is None:
            log(f"  SASS: no probe kernel for {what} in the library")
            counts.append(None)
            continue
        static, fewest, most, ops = sass_fp64_paths(funcs[name])
        if fewest is None:
            log("\n".join(funcs[name]))
        log(f"  SASS of one antiderivative ({what}, probe kernel): FP64-pipe "
            f"instructions static {static}, on a storing path fewest "
            f"{fewest} and most {most} (probe's 3 for the factors "
            f"included); by opcode {ops}")
        counts.append(None if fewest is None else fewest - 3)
    return tuple(counts)


def sass_loop_body(lines):
    """The loop with the most instructions in one kernel's ``cuobjdump
    -sass`` listing: (instructions from a backward branch's target to the
    branch, NOPs left out; {opcode: count}; inner backward branches in it),
    or (None, {}, 0) where the listing has no backward branch."""
    import re

    ins, at = [], {}
    for line in lines:
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        at[addr] = len(ins)
        tgt = re.search(r"\b0x([0-9a-f]+)\s*$", m.group(4))
        ins.append((addr, m.group(3).split(".")[0],
                    int(tgt.group(1), 16) if tgt else None))
    loops = [(at[t], i) for i, (addr, op, t) in enumerate(ins)
             if op == "BRA" and t is not None and t < addr and t in at]
    if not loops:
        return None, {}, 0
    lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
    ops = {}
    for _, op, _ in ins[lo:hi + 1]:
        if op != "NOP":
            ops[op] = ops.get(op, 0) + 1
    inner = sum(1 for a, b in loops if lo <= a and b < hi)
    return sum(ops.values()), ops, inner


def _k1_sass_functions():
    """{mangled name: SASS lines} of every kernel in the built K1/K4
    library (``cuobjdump -sass``), or None where that fails."""
    import re

    from repro_torch import kernels

    try:
        tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
        text = subprocess.run(
            [tool, "-sass", str(kernels.library_path("fused_masked_scan"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log(f"  cuobjdump -sass failed ({e}): K1's floors not measured")
        return None
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def k1_sass_count(spl, rows):
    """Instructions a warp issues per staged tuple on K1's main path: the
    stage loop of ``fms_partials<2, 1, spl>`` (two measures, 32-bit
    category words, ``spl`` snippets a lane) in the built library, over the
    ``rows`` tuples a stage it folds (ring upkeep included), and that loop's
    opcodes. (None, {}) where cuobjdump or the parse fails: the instruction
    floor is then not measured."""
    funcs = _k1_sass_functions()
    if funcs is None:
        return None, {}
    what = f"fms_partials<2, 1, {spl}>"
    name = next((k for k in funcs if f"fms_partialsILi2ELi1ELi{spl}EE" in k),
                None)
    if name is None:
        log(f"  SASS: no {what} in the library")
        return None, {}
    count, ops, inner = sass_loop_body(funcs[name])
    if count is None or inner:
        log(f"  SASS of {what}: no single stage loop ({inner} inner loops):"
            " K1's floor not measured")
        return None, ops
    per_tuple = count / rows
    log(f"  SASS of {what}: its stage loop is {count} "
        f"instructions for {rows} tuples, {per_tuple:.3f} a tuple "
        f"per warp; by opcode {dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    return per_tuple, ops


FP64_PIPE = ("DSETP", "DFMA", "DADD", "DMUL", "DMNMX")


def k1_any_sass_count(m, words, rows):
    """Instructions a warp issues per tuple in ``fms_partials_any<m,
    words>`` at phase 4's shape (L = 9, C = 1, V = 8). The stage loop (the
    largest loop) holds two versions of the tuple loop (the loops inside it
    with DFMAs; a tuple's copies told by their count, 2m a tuple): one for
    L within the registers' dims, with no loop inside, which this shape
    runs, and one with the loop over the dims past them. A tuple costs the
    first version over its copies plus the rest of the stage loop, both
    versions left out, over the ``rows`` tuples of a stage (the ring's
    copy loops counted once a stage). Returns (all, FP64-pipe instructions
    a tuple, opcodes of the tuple loop run), or (None, None, {})."""
    import re

    funcs = _k1_sass_functions()
    name = None if funcs is None else next(
        (k for k in funcs if f"fms_partials_anyILi{m}ELi{words}EE" in k),
        None)
    what = f"fms_partials_any<{m}, {words}>"
    if name is None or m < 1:
        log(f"  SASS: no {what} read: its floor not measured")
        return None, None, {}
    ins, at = [], {}
    for line in funcs[name]:
        mt = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if not mt:
            continue
        addr = int(mt.group(1), 16)
        at[addr] = len(ins)
        tgt = re.search(r"\b0x([0-9a-f]+)\s*$", mt.group(4))
        ins.append((addr, mt.group(3).split(".")[0],
                    int(tgt.group(1), 16) if tgt else None))
    loops = [(at[t], i) for i, (addr, op, t) in enumerate(ins)
             if op == "BRA" and t is not None and t < addr and t in at]
    if not loops:
        return None, None, {}
    stage = max(loops, key=lambda ab: ab[1] - ab[0])
    inside = [ab for ab in loops if stage[0] <= ab[0] and ab[1] <= stage[1]
              and ab != stage]
    top = [ab for ab in inside if not any(
        o != ab and o[0] <= ab[0] and ab[1] <= o[1] for o in inside)]

    def opcodes(lo, hi):
        ops = {}
        for _, op, _ in ins[lo:hi + 1]:
            if op != "NOP":
                ops[op] = ops.get(op, 0) + 1
        return ops

    folds = [ab for ab in top if opcodes(*ab).get("DFMA", 0)]
    flat = [ab for ab in folds if not any(
        o != ab and ab[0] <= o[0] and o[1] <= ab[1] for o in inside)]
    if len(flat) != 1:
        log(f"  SASS of {what}: {len(flat)} tuple loops with no loop inside "
            "in its stage loop, not one: floor not measured")
        return None, None, {}
    f_ops, s_ops = opcodes(*flat[0]), opcodes(*stage)
    copies = f_ops["DFMA"] / (2 * m)
    if copies < 1 or copies != int(copies):
        log(f"  SASS of {what}: {f_ops['DFMA']} DFMA in its tuple loop, not "
            "a whole number of tuples: floor not measured")
        return None, None, f_ops
    rest = dict(s_ops)
    for ab in folds:
        for k, v in opcodes(*ab).items():
            rest[k] -= v

    def fp64(ops):
        return sum(ops.get(k, 0) for k in FP64_PIPE)

    n_f, n_s, n_r = sum(f_ops.values()), sum(s_ops.values()), sum(
        rest.values())
    per = n_f / copies + n_r / rows
    fp = fp64(f_ops) / copies + fp64(rest) / rows
    def top(ops, n=None):
        return dict(sorted(((k, v) for k, v in ops.items() if v),
                           key=lambda kv: -kv[1])[:n])

    log(f"  SASS of {what}: stage loop {n_s} instructions, of which the "
        f"tuple loop run {n_f} for {int(copies)} tuples and {n_r} outside "
        f"the tuple loops for {rows}: {per:.3f} instructions and {fp:.3f} "
        "FP64-pipe instructions a tuple a warp; outside the tuple loops by "
        f"opcode {top(rest, 12)}; tuple loop by opcode {top(f_ops)}")
    return per, fp, f_ops


def max_sm_clock_hz():
    """The card's largest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.split()[0]) * 1e6


def _k3_premise(dev):
    """The Gram kernel's premise on the card: the kernels' own F and dF/dz
    are even bit for bit, and erf odd, over 0, subnormals, erf's branch
    points and |u/z| > 6, in float64 and float32."""
    import torch
    from repro_torch.kernels.se_covariance import ops as se

    n_vals = 0
    for dt, np_dt in ((torch.float64, np.float64), (torch.float32,
                                                    np.float32)):
        info = np.finfo(np_dt)
        r = np.concatenate([
            [0.0, info.smallest_subnormal, 4 * info.smallest_subnormal,
             info.tiny, 0.84375, 1.0, 1.25, 2.857142857142857, 5.9, 6.0, 6.5,
             27.0, 1e10],
            np.logspace(np.log10(float(info.tiny)), 2, 20000),
            np.linspace(0.0, 7.0, 700001)]).astype(np_dt)
        r = np.concatenate([r, np.nextafter(r, np.inf).astype(np_dt),
                            np.nextafter(r, -np.inf).astype(np_dt)])
        for z in (0.3, 0.77, 1.5):
            u = torch.as_tensor(np.abs(r) * np_dt(z), device=dev)
            f, df = se.se_cov_probe(u, z, with_derivative=True)
            fm, dfm = se.se_cov_probe(-u, z, with_derivative=True)
            rr = u / torch.tensor(z, dtype=dt, device=dev)
            odd = torch.equal(torch.special.erf(-rr), -torch.special.erf(rr))
            torch.cuda.synchronize()
            bad = (f != fm) | (df != dfm)
            assert not bool(bad.any()), (
                "K3 premise fails: F(-u) != F(u) at u = "
                f"{u[bad][:8].tolist()} ({dt}, z = {z})")
            assert odd, f"erf is not bitwise odd on the card ({dt})"
            n_vals += u.numel()
    log(f"  premise: the kernels' F(-u) == F(u) and dF(-u) == dF(u) bitwise, "
        f"and erf(-r) == -erf(r), at {n_vals} values (f64 and f32; 0, "
        "subnormals, erf's branch points, |u/z| up to 1e10)")


def _k3_seq(args, l):
    """The plain version's clamped per-dimension integrals multiplied in
    the kernels' order ((g0 g1) g2) and scaled as they scale."""
    import torch
    from repro_torch.kernels.se_covariance.ref import se_double_integral

    lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j = args
    g = torch.clamp(se_double_integral(lo_i[:, None, :], hi_i[:, None, :],
                                       lo_j[None], hi_j[None], ls), min=0.0)
    seq = g[..., 0]
    for k in range(1, l):
        seq = seq * g[..., k]
    return sigma2 * seq / (norm_i[:, None] * norm_j[None, :])


def _rel(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())


def check_k3(seed, dev):
    import torch
    from repro_torch.kernels.se_covariance import ops as se
    from repro_torch.kernels.se_covariance.ref import (se_cov_derivs_ref,
                                                       se_cov_grad_ref,
                                                       se_cov_matrix_ref)

    log("-- K3 premise: the kernels' antiderivative F(u; z) is even bit for "
        "bit (the Gram kernel's (b, a) entry reuses (a, b)'s values)")
    log("-- K3 se_cov_matrix (general forward): against the plain version on "
        "the card, f64 rtol 1e-12 on ranges wider than 0.05 and rtol 1e-3 on "
        "equality ranges, f32 rtol 2e-5 atol 1e-7 (the reference's f32 "
        "budget); repeat bitwise; f64 bitwise equal to the plain version's "
        "per-dimension integrals multiplied in the kernel's order")
    log("-- K3 se_cov_gram (Gram forward, the ranges passed once): bitwise "
        "the general kernel on the same ranges (f64 and f32), the f64 "
        "per-dimension contract, repeat bitwise")
    log("-- K3 se_cov_derivs (forward with derivatives): K bitwise the "
        "forward without; D within rtol 1e-12 of the plain "
        "se_cov_derivs_ref; Gram D bitwise general D")
    log("-- K3 se_cov_grad (reduction of the saved derivatives, the "
        "backward): against torch.autograd.grad of the plain version on the "
        "card, f64 rtol 1e-9 (another summation order over n_i*n_j terms); "
        "repeat bitwise; the autograd path bitwise se_cov_grad; the Gram "
        "route's bitwise the general route's")
    _k3_premise(dev)
    per_anti = k3_sass_counts()
    l, sigma2, n = 3, 1.7, SYNOPSIS_C
    records = {}
    rng = np.random.default_rng(seed + 13)
    ls = torch.as_tensor(rng.uniform(0.3, 1.5, l), device=dev)

    def sass_ms(antiderivs, derivs=False):
        c = per_anti[1 if derivs else 0]
        return None if c is None else c * antiderivs / FP64_PIPE_LANES_PER_S * 1e3

    def record(key, name, label, fn, plain_fn, n_bytes, n_ops, dtype, err,
               sass):
        ms = time_ms(fn, inner=10)
        plain = time_ms(plain_fn, reps=10)
        rec = report(name, label, ms, plain, n_bytes, n_ops, dtype, err)
        rec["device_ms"] = device_ms_per_call(f"{name} {label}", fn)
        rec["sass_bound_ms"] = sass
        if sass is not None:
            dev_share = (f", {sass / rec['device_ms']:.4f} of the device time"
                         if rec["device_ms"] else "")
            log(f"  {name} {label}: SASS-count bound {sass:.6f} ms (fewest "
                "FP64-pipe instructions an antiderivative x antiderivatives "
                f"/ 17.0e12 a s): {sass / ms:.4f} of the CUDA-event time"
                + dev_share)
        records[key] = rec

    # 1. The general kernel at improve's shape and at 2000 x 2000.
    sides = {}
    for n_i in (128, n):
        lo_i, hi_i = _se_inputs(rng, n_i, l)
        lo_j, hi_j = _se_inputs(rng, n, l)
        norm_i, norm_j = rng.uniform(0.5, 2.0, n_i), rng.uniform(0.5, 2.0, n)
        f64 = [torch.as_tensor(v, device=dev) for v in
               (lo_i, hi_i, lo_j, hi_j)]
        ni_t = torch.as_tensor(norm_i, device=dev)
        nj_t = torch.as_tensor(norm_j, device=dev)
        sides[n_i] = (*f64, ls, sigma2, ni_t, nj_t)
        want64 = se_cov_matrix_ref(*sides[n_i])
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
                dt, _rel(got, want))
            err = float((got - want).abs().max())
            name = str(dt).replace("torch.", "")
            same_seq = bool(torch.equal(got, _k3_seq(args, l)))
            if dt == torch.float64:
                assert same_seq, "K3 f64 differs from the plain version's " \
                    "per-dimension integrals multiplied in its order"
            log(f"  se_cov_matrix {n_i}x{n} {name}: bitwise equal to the "
                f"plain version on the card: {bool(torch.equal(got, want))} "
                f"({int((got != want).sum())} of {got.numel()} differ); "
                "to its per-dimension integrals multiplied in the kernel's "
                f"order: {same_seq}; largest relative difference "
                f"{_rel(got, want):.3e}; against the f64 plain version "
                f"{_rel(got.double(), want64):.3e}")
            size = 8 if dt == torch.float64 else 4
            record(("general", n_i, name), "se_cov_matrix",
                   f"{n_i}x{n} l={l} {name}",
                   lambda: se.se_cov_matrix(*args),
                   lambda: se_cov_matrix_ref(*args),
                   size * (2 * (n_i + n) * l + l + n_i + n + 1 + n_i * n),
                   _k3_ops(n_i, n, l)["general"],
                   "float64_simt" if dt == torch.float64 else "float32", err,
                   sass_ms(4 * l * n_i * n) if dt == torch.float64 else None)
        # Equality ranges: 1e-6 wide dim 0, ~12 digits cancel (f64 only).
        eq_i = [torch.as_tensor(v, device=dev)
                for v in _se_inputs(rng, n_i, l, equality=True)]
        eq = (*eq_i, *f64[2:], ls, sigma2, ni_t, nj_t)
        got, want = se.se_cov_matrix(*eq), se_cov_matrix_ref(*eq)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=1e-3, atol=0.0)
        log(f"  equality ranges {n_i}x{n} f64: largest relative difference "
            f"{_rel(got, want):.3e}, bitwise {bool(torch.equal(got, want))}")

    # 2. The Gram kernel at 2000 x 2000: the general case's i side, once.
    lo, hi, _, _, _, _, norm, _ = sides[n]
    ops = _k3_ops(n, n, l)
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        g_lo, g_hi, g_ls, g_norm = (t.to(dt) for t in (lo, hi, ls, norm))
        gargs = (g_lo, g_hi, g_ls, sigma2, g_norm)
        full = (g_lo, g_hi, g_lo, g_hi, g_ls, sigma2, g_norm, g_norm)
        got = se.se_cov_gram(*gargs)
        again = se.se_cov_gram(*gargs)
        general = se.se_cov_matrix(*full)
        want = se_cov_matrix_ref(*full)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "K3 Gram is not bitwise across runs"
        assert torch.equal(got, general), (
            f"K3 Gram differs from the general kernel ({name}) in "
            f"{int((got != general).sum())} entries")
        same_seq = bool(torch.equal(got, _k3_seq(full, l)))
        if dt == torch.float64:
            assert same_seq, "K3 Gram f64 differs from the plain version's " \
                "per-dimension integrals multiplied in its order"
        log(f"  se_cov_gram {n}x{n} {name}: bitwise the general kernel on the "
            f"same ranges: True; repeat bitwise: True; to the plain "
            f"version's per-dimension integrals in the kernel's order: "
            f"{same_seq}; largest relative difference to the plain version "
            f"{_rel(got, want):.3e}")
        size = 8 if dt == torch.float64 else 4
        record(("gram", name), "se_cov_gram", f"{n}x{n} l={l} {name}",
               lambda: se.se_cov_gram(*gargs),
               lambda: se_cov_matrix_ref(*full),
               size * (2 * n * l + l + n + 1 + n * n), ops["gram"],
               "float64_simt" if dt == torch.float64 else "float32",
               float((got - want).abs().max()),
               sass_ms(4 * l * n * (n + 1) // 2)
               if dt == torch.float64 else None)
        del got, again, general, want

    # 3. The derivatives (f64): the Gram route against the general route
    # and the plain version.
    full = (lo, hi, lo, hi, ls, sigma2, norm, norm)
    k_g, d_g = se.se_cov_gram_derivs(lo, hi, ls, sigma2, norm)
    k_gen, d_gen = se.se_cov_derivs(*full)
    want_k, want_d = se_cov_derivs_ref(*full)
    torch.cuda.synchronize()
    assert torch.equal(k_g, se.se_cov_gram(lo, hi, ls, sigma2, norm)), (
        "writing the derivatives changed the Gram forward's bits")
    assert torch.equal(k_g, k_gen) and torch.equal(d_g, d_gen), (
        "K3 Gram derivatives differ from the general kernel's")
    assert torch.allclose(d_g, want_d, rtol=1e-12, atol=0.0), _rel(d_g,
                                                                   want_d)
    err_d = float((d_g - want_d).abs().max())
    log(f"  se_cov_gram_derivs {n}x{n} f64: K and D bitwise the general "
        f"kernel's; D against se_cov_derivs_ref: bitwise "
        f"{bool(torch.equal(d_g, want_d))} ({int((d_g != want_d).sum())} of "
        f"{d_g.numel()} differ), largest relative difference "
        f"{_rel(d_g, want_d):.3e}")
    del k_g, k_gen, d_gen, want_k
    record("derivs", "se_cov_derivs", f"{n}x{n} l={l} float64 Gram",
           lambda: se.se_cov_gram_derivs(lo, hi, ls, sigma2, norm),
           lambda: se_cov_derivs_ref(*full),
           8 * (2 * n * l + l + n + 1 + (1 + l) * n * n), ops["derivs"],
           "float64_simt", err_d, sass_ms(4 * l * n * (n + 1) // 2, True))

    # 4. The gradient: the general route (two sides), then the Gram route.
    g_out = torch.as_tensor(rng.normal(size=(n, n)), device=dev)
    two = sides[n]
    got = se.se_cov_grad(*two, g_out)
    again = se.se_cov_grad(*two, g_out)
    want = se_cov_grad_ref(*two, g_out)
    z = ls.clone().requires_grad_(True)
    (via,) = torch.autograd.grad(
        se.se_cov_matrix(*two[:4], z, *two[5:]), z, g_out)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "K3 gradient is not bitwise across runs"
    assert torch.equal(got, via), "autograd did not run the reduction"
    assert torch.allclose(got, want, rtol=1e-9, atol=0.0), (got, want)
    log(f"  se_cov_grad {n}x{n} f64 (general route): {got.tolist()} against "
        f"{want.tolist()}, largest relative difference {_rel(got, want):.3e}"
        "; autograd path bitwise; repeat bitwise")
    k_mat = se.se_cov_gram(lo, hi, z, sigma2, norm)
    (via_g,) = torch.autograd.grad(k_mat, z, g_out, retain_graph=True)
    (again_g,) = torch.autograd.grad(k_mat, z, g_out, retain_graph=True)
    general = se.se_cov_grad(*full, g_out)
    want_g = se_cov_grad_ref(*full, g_out)
    torch.cuda.synchronize()
    assert torch.equal(via_g, again_g), "K3 Gram gradient is not bitwise"
    assert torch.equal(via_g, general), (
        "K3 Gram gradient differs from the general route's")
    assert torch.allclose(via_g, want_g, rtol=1e-9, atol=0.0), (via_g, want_g)
    log(f"  se_cov_grad {n}x{n} f64 (Gram route, through autograd): "
        f"{via_g.tolist()} against {want_g.tolist()}, largest relative "
        f"difference {_rel(via_g, want_g):.3e}; bitwise the general route "
        "and on a repeat")
    # The backward's launches alone (the reduction and its fold), then the
    # whole backward through autograd, as refit runs it.
    record("grad", "se_cov_grad", f"{n}x{n} l={l} float64 reduction",
           lambda: se._launch_reduce(g_out, d_g),
           lambda: (g_out[None] * want_d).sum((1, 2)),
           8 * ((1 + l) * n * n + l), ops["reduce"], "float64_simt",
           float((via_g - want_g).abs().max()), None)
    log(f"  se_cov_grad {n}x{n} f64 backward through autograd: "
        f"{time_ms(lambda: torch.autograd.grad(k_mat, z, g_out, retain_graph=True), inner=10):.6f}"
        " ms (CUDA events: the autograd engine's host work included)")
    del k_mat, want_d, d_g
    log("  library_ms is null for every K3 kernel: no single PyTorch call "
        "computes the SE double-integral product, its derivatives or their "
        "reduction against a gradient")
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
    # Every covariance build runs a K3 forward: improve (and the ingest
    # cross block) the general kernel, the ingest blocks the Gram kernel;
    # with no lengthscale gradient to take, none writes derivatives.
    log(f"K3 launches by route: Gram {counts['se_cov_gram']}, general "
        f"{counts['se_cov_matrix']}, with derivatives "
        f"{counts['se_cov_derivs']}, reductions {counts['se_cov_grad']}")
    assert counts["se_cov_matrix"] > 0 and counts["se_cov_gram"] > 0, counts
    assert counts["se_cov_derivs"] == 0 and counts["se_cov_grad"] == 0, counts
    # One group discovery (one K6 launch) a query with a group-by.
    n_grouped = sum(bool(q.groupby) for q in serve)
    log(f"K6 launches {counts['group_discovery']}, one for each of the "
        f"{n_grouped} group-by queries")
    assert counts["group_discovery"] == n_grouped > 0, counts
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
    # Every Adam step builds its NLL's Gram matrix with derivatives and
    # reduces them in its backward; the rebuilds after the fits take the
    # Gram route too, and nothing takes the general one.
    log(f"K3 launches by route in the refit: Gram {counts['se_cov_gram']}, "
        f"general {counts['se_cov_matrix']}, with derivatives "
        f"{counts['se_cov_derivs']}, reductions {counts['se_cov_grad']}")
    assert counts["se_cov_derivs"] >= REFIT_STEPS * len(fits), counts
    assert counts["se_cov_gram"] >= counts["se_cov_derivs"] + len(fits), (
        counts)
    assert counts["se_cov_grad"] >= REFIT_STEPS * len(fits), counts
    assert counts["se_cov_matrix"] == 0, counts

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
    # Group discovery runs on the engine's device, whatever the placement.
    assert (msh["counts"]["group_discovery"]
            == loc["counts"]["group_discovery"] > 0), msh["counts"]
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


# ------------------------------------------------------------------ phase 7
INTEL_FRESH = 200  # fresh queries of phase 7's stream
INTEL_REPEATS = 60  # exact repeats of the first of them
INTEL_WARM = 200  # warm-up queries of each session
INTEL_ROUTER = 12  # queries of the router's stream under each ingest mode
INTEL_TARGET = 0.02  # the stream's target_rel_error


def _intel_stream(seed, schema, fresh):
    """Phase 7's stream after ``fresh``: ``(kind, query, source)`` triples.
    ``source`` is the fresh query whose cached cells a subsumed answer must
    reproduce. Exact repeats; for each grouped fresh query a subset of its
    groups and a pin of one group (its grouped dim then dropped); for each
    other fresh query of the first 40 its numeric box narrowed by half
    the predicate epsilon; three uncacheable queries."""
    from repro_torch.aqp import queries as Q
    from repro_torch.kernels import RANGE_EPS

    rng = np.random.default_rng(seed)
    out = [("repeat", q, q) for q in fresh[:INTEL_REPEATS]]
    for q in fresh[:40]:
        if q.groupby:
            sub = tuple(int(v) for v in rng.choice(3, 2, replace=False))
            out.append(("subset", Q.AggQuery(
                q.aggs, q.predicates + (Q.CatIn(0, sub),), q.groupby), q))
            pin = int(rng.integers(0, 3))
            out.append(("pin", Q.AggQuery(
                q.aggs, q.predicates + (Q.CatEq(0, pin),), ()), q))
        else:
            preds = tuple(
                Q.NumRange(p.dim, p.lo + RANGE_EPS / 2, p.hi - RANGE_EPS / 2)
                if isinstance(p, Q.NumRange) else p for p in q.predicates)
            out.append(("narrowed", Q.AggQuery(q.aggs, preds, q.groupby), q))
    for q in fresh[:3]:
        out.append(("uncacheable", Q.AggQuery(
            q.aggs, q.predicates + (Q.TextLike("x%"),), q.groupby), None))
    return out


def _subsumed_cells(kind, source_cells, query):
    """What a subsumed answer must be: the cached cells filtered to the
    query's groups and projected onto its group-by (plain code, not the
    cache's)."""
    from repro_torch.aqp import queries as Q

    if kind == "narrowed":
        return source_cells
    pred = query.predicates[-1]
    members = ({pred.value} if isinstance(pred, Q.CatEq)
               else set(pred.values))
    keep = [c for c in source_cells if c["group"][0] in members]
    if kind == "pin":
        return [dict(c, group=()) for c in keep]
    return keep


def _intel_cells(ans):
    return [(c.group, c.agg, c.kind, c.estimate, c.beta2) for c in ans.cells]


def _router_run(rel, cfg, qs, async_ingest):
    """The router under a budget never met: a session with route
    switching (a probe every 4 scans, no ladder) against an always-improve
    twin, both cold. Returns each query's route and answer."""
    import dataclasses

    from repro_torch.intel import IntelConfig, RouterConfig
    from repro_torch.verdict import ErrorBudget, connect

    tight = ErrorBudget(target_rel_error=1e-9)
    c = dataclasses.replace(cfg, async_ingest=async_ingest)
    s = connect(rel, c, cache=IntelConfig(router=RouterConfig(
        probe_every=4, learn_ladder=False)))
    twin = connect(rel, c, cache=IntelConfig(router=RouterConfig(
        route_switching=False, learn_ladder=False)))
    routes, answers = [], []
    for i, q in enumerate(qs):
        before = dict(s.stats()["intel"]["routes"])
        a, w = s.execute(q, tight), twin.execute(q, tight)
        after = s.stats()["intel"]["routes"]
        routes.append(next(r for r in after if after[r] != before[r]))
        assert a.served_from is None and w.served_from is None, i
        assert a.batches_used == w.batches_used == cfg.n_batches, (
            i, a.batches_used, w.batches_used)
        assert _intel_cells(a) == _intel_cells(w), (
            f"router query {i} (route {routes[-1]}) differs from the "
            "always-improve twin")
        answers.append(_intel_cells(a))
    s.drain(), twin.drain()
    _assert_healthy(s.engine), _assert_healthy(twin.engine)
    return routes, answers, s.stats()["intel"]["router"]


def workload_intelligence(rel, cfg, seed, smi):
    """Phase 7 on phase 3's relation: the answer cache, subsumption,
    staleness, the router and the intel checkpoint through ``connect(...,
    cache=True)`` on the card."""
    import tempfile

    import torch
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.core.append import estimate_append_stats
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.intel import IntelConfig, QuerySignature
    from repro_torch.kernels import launch_counts
    from repro_torch.verdict import ErrorBudget, connect

    log(f"== phase 7: workload intelligence on {rel.device}, "
        f"{rel.cardinality} rows; card: {smi}")
    budget = ErrorBudget(target_rel_error=INTEL_TARGET)
    warm = tpch_workload(seed + 20, rel.schema, INTEL_WARM)
    fresh = tpch_workload(seed + 21, rel.schema, INTEL_FRESH)
    s = connect(rel, cfg, cache=True)
    # The twin is fed the cached session's misses, in order. It carries the
    # same serve-path router with a cache that holds nothing: the router's
    # "scan" route answers from the full budget where an always-improving
    # engine stops early, so only a twin routing alike can match a miss bit
    # for bit (part 4 holds the router against an always-improve twin).
    twin = connect(rel, cfg, cache=IntelConfig(capacity=0))
    plain = connect(rel, cfg)  # no intel plane, fed the whole stream: timing
    t0 = time.perf_counter()
    warm_answers = [sess.execute_many(warm) for sess in (s, twin, plain)]
    for sess in (s, twin, plain):
        sess.drain()
    log(f"warm-up: {INTEL_WARM} queries through execute_many in each of "
        f"three sessions, {time.perf_counter() - t0:.3f} s")
    assert all(_intel_cells(a) == _intel_cells(b) == _intel_cells(c)
               for a, b, c in zip(*warm_answers)), "warm-ups differ"

    # 1. The stream: fresh queries, then repeats, subsumed and uncacheable.
    stream = [("fresh", q, None) for q in fresh] + _intel_stream(
        seed + 22, rel.schema, fresh)
    recorded = {}  # fresh query index -> its latest executed answer
    index = {id(q): i for i, q in enumerate(fresh)}
    lat = {"cached": [], "plain": [], "hit": [], "miss": []}
    counts = {"hit": 0, "subsumed": 0, "miss": 0, "uncacheable": 0}
    for i, (kind, q, source) in enumerate(stream):
        if kind != "fresh":
            # Quiesce every session's ingest thread (their covariance
            # builds launch K3) so the counters can see what a hit
            # launches; both timed sessions start each such query drained.
            for sess in (s, twin, plain):
                sess.drain()
        torch.cuda.synchronize()
        before = launch_counts()
        t = time.perf_counter()
        a = s.execute(q, budget)
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        after = launch_counts()
        lat["cached"].append(took)
        t = time.perf_counter()
        plain.execute(q, budget)
        torch.cuda.synchronize()
        lat["plain"].append(time.perf_counter() - t)
        if a.served_from is None:
            w = twin.execute(q, budget)
            assert w.served_from is None, (i, w.served_from)
            assert (a.batches_used, _intel_cells(a)) == (
                w.batches_used, _intel_cells(w)), (
                f"stream query {i} ({kind}): a miss differs from the "
                "cache-free twin")
            if kind == "uncacheable":
                assert QuerySignature.from_query(rel.schema, q) is None
                counts["uncacheable"] += 1
            else:
                counts["miss"] += 1
            if id(q) in index:
                recorded[index[id(q)]] = a
            lat["miss"].append(took)
            continue
        assert kind not in ("fresh", "uncacheable"), (i, kind)
        assert after == before, (
            f"stream query {i} ({kind}) was served from the cache but "
            f"launched kernels: {before} -> {after}")
        lat["hit"].append(took)
        if a.served_from == "cache:exact":
            assert kind == "repeat", (i, kind)
            counts["hit"] += 1
            want = recorded[index[id(q)]]
            assert _intel_cells(a) == _intel_cells(want), (
                f"stream query {i}: an exact hit differs from the recorded "
                "answer")
        else:
            assert a.served_from == "cache:subsumed" and kind != "repeat"
            counts["subsumed"] += 1
            # The cached cells are the source's latest executed answer.
            src = recorded[index[id(source)]]
            want = _subsumed_cells(kind, [c.to_dict() for c in src.cells], q)
            assert [(c.group, c.agg, c.kind, c.estimate, c.beta2)
                    for c in a.cells] == [
                (tuple(c["group"]), c["agg"], c["kind"], c["estimate"],
                 c["beta2"]) for c in want], (
                f"stream query {i} ({kind}): not the filter-and-project of "
                "the cached cells")
    for sess in (s, twin, plain):
        sess.drain()
        _assert_healthy(sess.engine)
    st = s.stats()["intel"]
    assert st["routes"] == {**twin.stats()["intel"]["routes"],
                            "cache": counts["hit"] + counts["subsumed"]}
    log(f"stream of {len(stream)} queries: exact hits {counts['hit']}, "
        f"subsumed {counts['subsumed']}, misses {counts['miss']}, "
        f"uncacheable {counts['uncacheable']}; every miss bitwise the "
        "twin fed the misses in order (same routes), every exact hit bitwise "
        "the recorded answer, every subsumed answer the filter-and-project "
        "of the cached cells, no kernel launched across a hit")
    log(f"  intel counters: lookups {st['lookups']}, hits_exact "
        f"{st['hits_exact']}, hits_subsumed {st['hits_subsumed']}, misses "
        f"{st['misses']}, stale_served {st['stale_served']}, stale_refused "
        f"{st['stale_refused']}, budget_refused {st['budget_refused']}, "
        f"uncacheable {st['uncacheable']}, routes {st['routes']}, learned "
        f"floors {st['router']['learned_floors']}")
    assert counts["hit"] > 0 and counts["subsumed"] > 0, counts
    assert counts["uncacheable"] == 3, counts
    e2e = {}
    for name in ("cached", "plain"):
        ms = np.asarray(lat[name]) * 1e3
        e2e[name] = {"qps": len(ms) / float(ms.sum() / 1e3),
                     "p50_ms": float(np.percentile(ms, 50))}
    for name in ("hit", "miss"):
        e2e[f"{name}_p50_ms"] = float(np.percentile(
            np.asarray(lat[name]) * 1e3, 50))
    log(f"same stream ({len(stream)} queries, host clock around a "
        f"synchronised call; {smi}): cached session "
        f"{e2e['cached']['qps']:.2f} q/s, p50 {e2e['cached']['p50_ms']:.3f} "
        f"ms; cache-free session {e2e['plain']['qps']:.2f} q/s, p50 "
        f"{e2e['plain']['p50_ms']:.3f} ms; hits alone ({len(lat['hit'])}) "
        f"p50 {e2e['hit_p50_ms']:.3f} ms, the cached session's misses "
        f"({len(lat['miss'])}) p50 {e2e['miss_p50_ms']:.3f} ms")
    del twin, plain

    # 2. Persistence: the intel payload through save_synopses /
    # load_synopses into a fresh session with a cache. A restore rebuilds
    # each inverse from Sigma; so that the restored session's misses can be
    # held bitwise too, the saving session rebuilds first.
    for _, syn in sorted(s.store.items()):
        syn.rebuild()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        s.save(mgr, step=1)
        restored = connect(rel, cfg, cache=True)
        restored.load(mgr, step=1)
    assert restored.stats()["intel"]["entries"] == st["entries"]
    served = []
    for i, q in enumerate(fresh[:20]):
        a, b = s.execute(q, budget), restored.execute(q, budget)
        assert a.served_from == b.served_from, (i, a.served_from,
                                                b.served_from)
        assert (a.batches_used, _intel_cells(a)) == (
            b.batches_used, _intel_cells(b)), f"restored repeat {i} differs"
        served.append(a.served_from)
    restored.drain()
    log(f"checkpoint with the intel payload ({st['entries']} entries) "
        f"restored into a fresh session with a cache on {rel.device}: 20 "
        "repeats served "
        f"alike ({served.count('cache:exact')} exact hits), bitwise")
    del restored

    # 3. Staleness: a full-accuracy entry is not served after an append.
    q = fresh[0]
    first = s.execute(q)
    again = s.execute(q)
    assert first.served_from is None and again.served_from == "cache:exact"
    gens = {k: s.store.generation(k) for k in s.store.keys()}
    n_new = rel.cardinality // 5
    new = rel.take(np.arange(n_new))
    stats = estimate_append_stats(rel.measures[:500],
                                  new.measures[:500] + 0.8,
                                  rel.cardinality, n_new)
    for _, syn in sorted(s.store.items()):
        syn.apply_append(stats)
    moved = {k: s.store.generation(k) - g for k, g in gens.items()}
    after = s.execute(q)
    assert all(v == 1 for v in moved.values()), moved
    assert after.served_from is None, after.served_from
    s.drain()
    _assert_healthy(s.engine)
    log(f"staleness: after apply_append on every synopsis the generations "
        f"moved by {sorted(set(moved.values()))}; the full-accuracy repeat "
        f"was executed (stale_refused {s.stats()['intel']['stale_refused']}"
        ")")
    del s

    # 4. The router, under each ingest mode, from cold sessions.
    rqs = tpch_workload(seed + 23, rel.schema, INTEL_ROUTER)
    runs = {}
    for mode in (True, False):
        t0 = time.perf_counter()
        runs[mode] = _router_run(rel, cfg, rqs, mode)
        log(f"router, async_ingest={mode}: routes {runs[mode][0]}, learned "
            f"E[batches] {runs[mode][2]['expected_batches']} in "
            f"{time.perf_counter() - t0:.3f} s")
    assert runs[True][:2] == runs[False][:2], (
        "routes or answers differ between the ingest modes")
    routes = runs[True][0]
    assert routes[0] == "improve" and "scan" in routes, routes
    log(f"router: {routes.count('scan')} of {len(routes)} queries routed "
        "scan, every answer bitwise the always-improve twin's, identical "
        "under async_ingest=True and False")
    return {**e2e, **counts}


# ------------------------------------------------------------------ phase 8
SERVE_WARM = 200  # warm-up queries of each of phase 8's sessions
SERVE_FRESH = 256  # queries of the concurrent burst
SERVE_THREADS = 8  # threads submitting the burst at once
SERVE_MAX_BATCH = 64  # the service's auto-flush threshold
SERVE_TARGET = 0.02  # the burst's target_rel_error
SERVE_MESH_QUERIES = 32  # queries of the local-against-mesh service check


def _served_bits(ans):
    return (ans.batches_used, [(c.group, c.agg, c.kind, c.estimate, c.beta2)
                               for c in ans.cells])


def _result_bits(r):
    return (r.batches_used, r.tuples_scanned, r.cells)


def _warm(sessions, warm):
    """The same warm-up through ``execute_many`` in each session, drained;
    their answers must agree bitwise. Returns the first session's."""
    answers = [sess.execute_many(warm) for sess in sessions]
    for sess in sessions:
        sess.drain()
    first = [_served_bits(a) for a in answers[0]]
    for other in answers[1:]:
        assert [_served_bits(a) for a in other] == first, "warm-ups differ"
    return answers[0]


def _burst(svc, queries):
    """``SERVE_THREADS`` threads submit ``queries`` at once (thread k takes
    queries k, k + SERVE_THREADS, ...) through the auto-flush, then one
    final flush. Returns each query's ticket and latency (s, submit to
    resolution, host clock; an answer is host floats, so the device work
    it needed is done), the flushes' queries in order, and the wall time
    (s)."""
    import threading

    import torch
    from repro_torch.serving import aqp as serving_aqp

    slices = []
    inner = svc._execute_slice

    def spy(qs):
        slices.append(list(qs))
        return inner(qs)

    svc._execute_slice = spy
    orig = serving_aqp.Ticket._resolve

    def stamped(ticket, result):
        ticket.resolved_at = time.perf_counter()
        orig(ticket, result)

    tickets, submitted = [None] * len(queries), [0.0] * len(queries)
    errors = []
    start = threading.Barrier(SERVE_THREADS)

    def submitter(k):
        try:
            start.wait()
            for i in range(k, len(queries), SERVE_THREADS):
                submitted[i] = time.perf_counter()
                tickets[i] = svc.submit(queries[i])
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append(e)

    serving_aqp.Ticket._resolve = stamped
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(SERVE_THREADS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        svc.flush()
        answers = [t.result(timeout=600) for t in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serving_aqp.Ticket._resolve = orig
        del svc._execute_slice
    assert all(t.resolutions == 1 for t in tickets), "a ticket resolved twice"
    assert svc.pending == 0, svc.pending
    failed = [i for i, a in enumerate(answers) if getattr(a, "failed", False)]
    assert not failed, [answers[i] for i in failed[:3]]
    ids = sorted(id(q) for s in slices for q in s)
    assert ids == sorted(id(q) for q in queries), "a query lost or run twice"
    lat = [t.resolved_at - s for t, s in zip(tickets, submitted)]
    return tickets, np.asarray(lat), slices, wall


def _replay(tickets, queries, slices, twin, budget):
    """Replay the service's flushes, in order, through ``twin``'s
    ``execute_many``: every served answer must be bitwise the twin's."""
    by_query = {id(q): t for q, t in zip(queries, tickets)}
    for k, qs in enumerate(slices):
        for j, (q, w) in enumerate(zip(qs, twin.execute_many(qs, budget))):
            got = by_query[id(q)].result()
            assert _served_bits(got) == _served_bits(w), (
                f"flush {k} query {j}: the service's answer differs from "
                "the twin's execute_many of the same slice")


def _ingest_summary(eng):
    stats = eng.ingest_stats()
    return ({k: v["high_water"] for k, v in stats.items()},
            {k: v["shed_count"] for k, v in stats.items()})


def serving_service(rel, cfg, seed, smi):
    """Phase 8 on phase 3's relation: the microbatching ``AqpService``
    (``Session.serve``) under concurrent submitters, ingest under load,
    faults, deadlines, the pre-screen and a mesh."""
    import dataclasses

    import torch
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.ft import faults
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import AqpService
    from repro_torch.verdict import ErrorBudget, FailedAnswer, Mesh, connect

    log(f"== phase 8: the microbatching AqpService on {rel.device}, "
        f"{rel.cardinality} rows; card: {smi}")
    t_phase = time.perf_counter()
    budget = ErrorBudget(target_rel_error=SERVE_TARGET)
    warm = tpch_workload(seed + 30, rel.schema, SERVE_WARM)
    fresh = tpch_workload(seed + 31, rel.schema, SERVE_FRESH)

    # 1. Concurrent submitters; a twin replays the flushes; a third session
    # answers the same queries one by one.
    s, twin, seq = (connect(rel, cfg) for _ in range(3))
    t0 = time.perf_counter()
    _warm((s, twin, seq), warm)
    log(f"warm-up: {SERVE_WARM} queries through execute_many in each of "
        f"three sessions, {time.perf_counter() - t0:.3f} s")
    svc = s.serve(max_batch=SERVE_MAX_BATCH, budget=budget)
    reset_launch_counts()
    eval_calls = []
    inner = svc._execute_slice

    def counted(qs):  # the scan rounds each flush ran
        out = inner(qs)
        eval_calls.append(svc.executor.stats.eval_calls)
        return out

    svc._execute_slice = counted
    tickets, lat, slices, wall = _burst(svc, fresh)
    s.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    k3 = counts["se_cov_matrix"] + counts["se_cov_gram"]
    assert counts["fused_masked_scan"] == sum(eval_calls) > 0, (
        counts, eval_calls)
    assert counts["gp_batch_infer"] > 0 and k3 > 0, counts
    assert counts["masked_partials"] == 0, counts
    high, shed = _ingest_summary(s.engine)
    _assert_healthy(s.engine)
    lat_ms = lat * 1e3
    e2e = {"qps": len(fresh) / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "flushes": len(slices), "flush_sizes": [len(q) for q in slices],
           "launches": {"K1": counts["fused_masked_scan"],
                        "K2": counts["gp_batch_infer"], "K3": k3},
           "high_water": max(high.values()), "shed": sum(shed.values())}
    log(f"service: {len(fresh)} queries from {SERVE_THREADS} threads in "
        f"{wall:.3f} s = {e2e['qps']:.2f} q/s; ticket latency p50 "
        f"{e2e['p50_ms']:.3f} ms, p99 {e2e['p99_ms']:.3f} ms; "
        f"{len(slices)} flushes of {e2e['flush_sizes']} queries, scan rounds "
        f"{eval_calls}; launches K1 {counts['fused_masked_scan']}, K2 "
        f"{counts['gp_batch_infer']}, K3 {k3} (general "
        f"{counts['se_cov_matrix']}, Gram {counts['se_cov_gram']}); every "
        "ticket resolved exactly once, none failed; ingest high_water "
        f"{high}, shed {shed}")
    t0 = time.perf_counter()
    _replay(tickets, fresh, slices, twin, budget)
    log(f"twin: the {len(slices)} flushes replayed in order through "
        "execute_many, every answer bitwise the service's "
        f"({time.perf_counter() - t0:.3f} s)")
    one = []
    t0 = time.perf_counter()
    for q in fresh:
        t = time.perf_counter()
        seq.execute(q, budget)
        torch.cuda.synchronize()
        one.append(time.perf_counter() - t)
    seq_wall = time.perf_counter() - t0
    one_ms = np.asarray(one) * 1e3
    e2e["one_by_one"] = {"qps": len(fresh) / seq_wall,
                         "p50_ms": float(np.percentile(one_ms, 50)),
                         "p99_ms": float(np.percentile(one_ms, 99))}
    log(f"one by one: the same {len(fresh)} queries through execute on a "
        f"third session, {e2e['one_by_one']['qps']:.2f} q/s, p50 "
        f"{e2e['one_by_one']['p50_ms']:.3f} ms, p99 "
        f"{e2e['one_by_one']['p99_ms']:.3f} ms ({smi})")
    for sess in (s, twin, seq):
        sess.drain()
    del s, twin, seq, svc

    # 2. Ingest under load: two pending batches a synopsis at most; the
    # answers and the final store bitwise a synchronous twin's.
    s2 = connect(rel, dataclasses.replace(cfg, ingest_max_pending=2))
    sync = connect(rel, dataclasses.replace(cfg, async_ingest=False))
    _warm((s2, sync), warm)
    svc2 = s2.serve(max_batch=SERVE_MAX_BATCH, budget=budget)
    tickets2, lat2, slices2, wall2 = _burst(svc2, fresh)
    _replay(tickets2, fresh, slices2, sync, budget)
    s2.drain()
    high2, shed2 = _ingest_summary(s2.engine)
    assert all(v <= 2 for v in high2.values()), high2
    got_sd = s2.engine.synopses_state_dict()
    want_sd = sync.engine.synopses_state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name in want_sd:
        for k in want_sd[name]:
            if k == "ingest_high_water":  # telemetry, not model state
                continue
            assert np.array_equal(np.asarray(got_sd[name][k]),
                                  np.asarray(want_sd[name][k])), (name, k)
    _assert_healthy(s2.engine)
    e2e["bounded"] = {"qps": len(fresh) / wall2,
                      "p50_ms": float(np.percentile(lat2 * 1e3, 50)),
                      "flushes": len(slices2), "high_water": high2,
                      "shed": shed2}
    log(f"ingest_max_pending=2: {len(fresh)} queries in {wall2:.3f} s = "
        f"{e2e['bounded']['qps']:.2f} q/s, p50 "
        f"{e2e['bounded']['p50_ms']:.3f} ms, {len(slices2)} flushes; "
        f"high_water {high2} (bound 2), shed {shed2}; answers and final "
        "store bitwise the async_ingest=False twin fed the same slices")
    del s2, sync, svc2

    # 3. Faults on 4-query slices.
    qs4 = fresh[:4]
    chaos, clean = connect(rel, cfg), connect(rel, cfg)
    svc3 = chaos.serve(max_batch=SERVE_MAX_BATCH, budget=budget)
    calls = []
    inner3 = svc3._execute_slice

    def counting(qs):
        calls.append(len(qs))
        return inner3(qs)

    svc3._execute_slice = counting
    got = [svc3.submit(q) for q in qs4]
    with faults.inject(faults.FaultSpec("scan.eval", hits=(0,))) as plan:
        svc3.flush()
        assert plan.fires.get("scan.eval") == 1, plan.fires
    assert calls == [4, 4], calls  # the slice, failed; again, clean
    want = clean.serve(max_batch=SERVE_MAX_BATCH, budget=budget).execute(qs4)
    assert [_served_bits(t.result()) for t in got] == [
        _served_bits(w) for w in want], "the retried slice differs"
    psvc = AqpService(chaos.engine, max_batch=SERVE_MAX_BATCH,
                      target_rel_error=SERVE_TARGET, max_retries=1,
                      backoff_base_s=0.001)
    doomed = [psvc.submit(q) for q in fresh[4:8]]
    with faults.inject(faults.FaultSpec("scan.eval", rate=1.0)):
        psvc.flush()
    for t in doomed:
        ans = t.result()
        assert isinstance(ans, FailedAnswer), ans
        assert ans.error_type == "InjectedFault" and ans.attempts == 5, ans
    ok = psvc.submit(fresh[4])
    psvc.flush()
    assert not getattr(ok.result(), "failed", False), ok.result()
    chaos.drain(), clean.drain()
    _assert_healthy(chaos.engine)
    log("faults: a transient scan.eval fault cost exactly two slice "
        "executions [4, 4], answers bitwise a clean twin's; a persistent "
        "one resolved 4 tickets to FailedAnswer(InjectedFault, attempts 5), "
        "and the service answered again once it was gone")
    del chaos, clean

    # 4. A deadline of 0 s: degraded answers, never cached; with a cache a
    # repeat is pre-screened, bitwise, launching nothing.
    cached = connect(rel, cfg, cache=True)
    dsvc = cached.serve(max_batch=4, budget=ErrorBudget(deadline_s=0.0))
    first = dsvc.submit(fresh[0]).result()
    assert first.degraded and "deadline" in first.degraded_reasons, first
    again = dsvc.submit(fresh[0])
    assert dsvc.prescreened == 0 and dsvc.pending == 1
    second = again.result()
    assert second.degraded and second.served_from is None
    assert cached.stats()["intel"]["insertions"] == 0
    hsvc = cached.serve(max_batch=SERVE_MAX_BATCH)  # full accuracy
    full = hsvc.submit(fresh[1]).result()
    cached.drain()
    torch.cuda.synchronize()
    before = launch_counts()
    t = time.perf_counter()
    hit = hsvc.submit(fresh[1])
    assert hit._done and hsvc.pending == 0 and hsvc.prescreened == 1
    hit_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    assert launch_counts() == before, "a pre-screened hit launched kernels"
    assert hit.result().served_from == "cache:exact"
    assert _served_bits(hit.result()) == _served_bits(full)
    log(f"deadline_s=0: degraded ({sorted(first.degraded_reasons)}), never "
        "cached (the repeat entered a microbatch); pre-screen: the repeat "
        f"of a full-accuracy answer resolved at submit in {hit_ms:.3f} ms, "
        "bitwise, no launch, pending 0")
    del cached

    # 5. The service over a four-shard mesh on the card: bitwise the local
    # service, K4 once per scan round and no K1.
    mesh = Mesh((rel.device,) * N_SHARDS)
    qs = fresh[:SERVE_MESH_QUERIES]
    runs = {}
    for name, kw in (("local", {}), ("mesh", {"mesh": mesh})):
        sess = connect(rel, cfg)
        msvc = AqpService(sess.engine, max_batch=SERVE_MAX_BATCH,
                          target_rel_error=SERVE_TARGET, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        res = msvc.execute(qs)
        sess.drain()
        torch.cuda.synchronize()
        runs[name] = (res, launch_counts(), msvc)
    (r_loc, c_loc, lsvc), (r_msh, c_msh, msvc) = runs["local"], runs["mesh"]
    rounds = msvc.last_stats.eval_calls
    assert msvc.executor.placement.blocks_evaluated == rounds > 0
    assert c_msh["masked_partials"] == rounds, (c_msh, rounds)
    assert c_msh["fused_masked_scan"] == 0, c_msh
    assert c_loc["fused_masked_scan"] == lsvc.last_stats.eval_calls > 0
    assert c_loc["masked_partials"] == 0, c_loc
    assert [_result_bits(r) for r in r_msh] == [
        _result_bits(r) for r in r_loc], "the mesh service differs"
    log(f"mesh: AqpService(mesh=Mesh(({rel.device},) * {N_SHARDS})) answered "
        f"{len(qs)} queries bitwise like the local service; K4 launches "
        f"{c_msh['masked_partials']} = {rounds} scan rounds, K1 0")
    e2e["mesh_rounds"] = rounds
    e2e["seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 took {e2e['seconds']:.1f} s")
    return e2e


# ------------------------------------------------------------------ phase 9
FRONT_WARM = 200  # warm-up queries of each engine and of each twin
FRONT_PER_TENANT = 64  # fresh queries each burst tenant posts
FRONT_CLIENTS = 8  # client threads of each burst tenant
FRONT_TARGET = 0.02  # the burst tenants' target_rel_error
FRONT_SHARED_HITS = 8  # web's burst queries posted again as bi
FRONT_STREAMS = 2  # fresh queries streamed to etl
FRONT_HEALTHZ = 50  # healthz round trips timed


def _http(base, path, body=None):
    """One request with ``urllib``: ``(status, headers, body bytes)``. An
    HTTP error status is returned as a value, as the front maps it."""
    import urllib.error
    import urllib.request

    data = (None if body is None else body if isinstance(body, bytes)
            else json.dumps(body).encode())
    req = urllib.request.Request(
        base + path, data=data,
        headers={} if data is None else {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _query_json(schema, q):
    """An engine ``AggQuery`` as the wire's query JSON, by column name."""
    from repro_torch.aqp import queries as Q

    preds = []
    for p in q.predicates:
        if isinstance(p, Q.NumRange):
            preds.append({"op": "between", "column": schema.num_names[p.dim],
                          "lo": float(p.lo), "hi": float(p.hi)})
        elif isinstance(p, Q.NumEq):
            preds.append({"op": "equals", "column": schema.num_names[p.dim],
                          "value": float(p.value)})
        elif isinstance(p, Q.CatEq):
            preds.append({"op": "equals", "column": schema.cat_names[p.dim],
                          "value": int(p.value)})
        else:
            preds.append({"op": "one_of", "column": schema.cat_names[p.dim],
                          "values": [int(v) for v in p.values]})
    aggs = [{"kind": "count"} if a.kind == "COUNT" else
            {"kind": a.kind.lower(), "measure": schema.measure_names[a.measure]}
            for a in q.aggs]
    return {"aggs": aggs, "where": preds,
            "group_by": [schema.cat_names[d] for d in q.groupby]}


def _wire_json(ans):
    """What the front sends for ``ans``, after the JSON round trip."""
    from repro_torch.serving.front import answer_to_json

    return json.loads(json.dumps(answer_to_json(ans)))


def _front_burst(base, plan, bodies):
    """``FRONT_CLIENTS`` client threads a tenant post, all at once, the
    tenant's queries (``plan``: tenant -> indices into ``bodies``) to its
    ``/execute``; thread k takes the tenant's queries k, k +
    ``FRONT_CLIENTS``, ... Returns each query's (status, body), its latency
    (s, host clock around the request) and the burst's wall time (s)."""
    import threading

    import torch

    got, lat, errors = {}, {}, []
    start = threading.Barrier(len(plan) * FRONT_CLIENTS)

    def client(name, k):
        try:
            start.wait()
            for i in plan[name][k::FRONT_CLIENTS]:
                t = time.perf_counter()
                status, _, raw = _http(base, f"/v1/tenants/{name}/execute",
                                       {"query": bodies[i]})
                lat[i] = time.perf_counter() - t
                got[i] = (status, json.loads(raw))
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(name, k))
               for name in plan for k in range(FRONT_CLIENTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    assert not errors, errors
    return got, lat, wall


def _handler_threads():
    import threading

    return [t for t in threading.enumerate()
            if "process_request_thread" in t.name
            or t.name == "serving-front-http"]


def serving_front(rel, cfg, seed, smi, hit_p50_ms):
    """Phase 9 on phase 3's relation: the multi-tenant ``ServingFront``
    through ``serve_http`` on 127.0.0.1, driven with ``urllib`` only."""
    import dataclasses

    import torch
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.front import (
        ServingFront,
        TenantSpec,
        query_from_json,
        serve_http,
    )
    from repro_torch.verdict import Cell, ErrorBudget, connect

    log(f"== phase 9: the multi-tenant serving front over HTTP on "
        f"{rel.device}, {rel.cardinality} rows; card: {smi}")
    t_phase = time.perf_counter()
    budget = ErrorBudget(target_rel_error=FRONT_TARGET)
    warm = tpch_workload(seed + 40, rel.schema, FRONT_WARM)
    fresh = tpch_workload(seed + 41, rel.schema,
                          3 * FRONT_PER_TENANT + FRONT_STREAMS + 1)
    bodies = [_query_json(rel.schema, q) for q in fresh]
    for q, b in zip(fresh, bodies):  # the wire lowers to the same query
        assert query_from_json(rel.schema, b).build() == q, (q, b)
    front = ServingFront(rel, cfg, cache=True)
    for name, iso in (("web", "shared"), ("bi", "shared"),
                      ("etl", "isolated")):
        front.add_tenant(TenantSpec(name, isolation=iso, rate=0,
                                    max_batch=64, budget=budget))
    front.add_tenant(TenantSpec("tiny", rate=0.001, burst=1))
    front.add_tenant(TenantSpec("full", max_pending=0))
    web, bi, etl = (front.tenant(n) for n in ("web", "bi", "etl"))
    twin_shared, twin_iso = (connect(rel, cfg, cache=True) for _ in range(2))
    t0 = time.perf_counter()
    warm_answers = _warm((web.session, etl.session, twin_shared, twin_iso),
                         warm)
    log(f"warm-up: {FRONT_WARM} queries through execute_many on the shared "
        f"engine, the isolated one and their twins, "
        f"{time.perf_counter() - t0:.3f} s")

    # Spies: the shared services' flushes go to one list (they run under
    # the shared engine lock, so its order is the engine's), etl's to its
    # own; each flush's scan rounds beside it.
    flushes = {"shared": [], "iso": []}
    rounds = []
    for tenant, sink in ((web, "shared"), (bi, "shared"), (etl, "iso")):
        svc = tenant.service
        inner = svc._execute_slice

        def spy(qs, svc=svc, inner=inner, sink=flushes[sink]):
            out = inner(qs)
            sink.append(list(qs))
            rounds.append(svc.executor.stats.eval_calls)
            return out

        svc._execute_slice = spy
    server = serve_http(front)
    host, port = server.server_address
    base = f"http://{host}:{port}"
    log(f"serving on {base} (ThreadingHTTPServer, one thread a request)")

    # 1. The burst: 8 client threads a tenant, 64 fresh queries a tenant.
    plan = {name: list(range(k * FRONT_PER_TENANT,
                             (k + 1) * FRONT_PER_TENANT))
            for k, name in enumerate(("web", "bi", "etl"))}
    reset_launch_counts()
    got, lat, wall = _front_burst(base, plan, bodies)
    web.session.drain(), etl.session.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    n_burst = 3 * FRONT_PER_TENANT
    assert sorted(got) == list(range(n_burst)), sorted(got)
    bad = [(i, s, b.get("kind")) for i, (s, b) in got.items()
           if s != 200 or b["kind"] != "answer"]
    assert not bad, bad[:5]
    k3 = counts["se_cov_matrix"] + counts["se_cov_gram"]
    # The launch counts add up: two engines flushed at once, and K1 counted
    # exactly one launch a scan round of every flush.
    assert counts["fused_masked_scan"] == sum(rounds) > 0, (counts, rounds)
    assert counts["gp_batch_infer"] > 0 and k3 > 0, counts
    assert counts["masked_partials"] == 0, counts
    for eng in (web.session.engine, etl.session.engine):
        _assert_healthy(eng)

    # Every miss bitwise the twins' replay of the same flushes, in order;
    # a pre-screened answer (if any) holds bitwise cells its engine
    # recorded before.
    by_query = {fresh[i]: i for i in range(n_burst)}
    t0 = time.perf_counter()
    flushed = set()
    cells_of = (lambda answers: {c[1:] for a in answers
                                 for c in _served_bits(a)[1]})
    recorded = {"shared": cells_of(warm_answers),
                "iso": cells_of(warm_answers)}
    for sink, twin in (("shared", twin_shared), ("iso", twin_iso)):
        for k, qs in enumerate(flushes[sink]):
            for j, (q, w) in enumerate(zip(qs, twin.execute_many(qs,
                                                                  budget))):
                i = by_query[q]
                flushed.add(i)
                assert got[i][1] == _wire_json(w), (
                    f"{sink} flush {k} query {j}: the HTTP answer differs "
                    "from the twin's execute_many of the same slice")
                recorded[sink].update(cells_of([w]))
    prescreened = sorted(set(range(n_burst)) - flushed)
    for i in prescreened:
        body = got[i][1]
        sink = "iso" if i in plan["etl"] else "shared"
        assert body["served_from"].startswith("cache:"), body
        # A cached answer's cells are literally recorded cells (filtered
        # to the query's groups and projected onto its group-by).
        assert all((c["agg"], c["kind"], c["estimate"], c["beta2"])
                   in recorded[sink] for c in body["cells"]), i
    replay_s = time.perf_counter() - t0
    st = json.loads(_http(base, "/v1/stats")[2])
    lat_ms = np.asarray([lat[i] for i in range(n_burst)]) * 1e3
    # Flush sizes as {size: flushes}, per engine.
    sizes = {s: {n: [len(q) for q in flushes[s]].count(n)
                 for n in sorted({len(q) for q in flushes[s]})}
             for s in flushes}
    e2e = {"qps": n_burst / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "flush_sizes": sizes, "prescreened": len(prescreened),
           "launches": {"K1": counts["fused_masked_scan"],
                        "K2": counts["gp_batch_infer"], "K3": k3},
           "tenants": {}}
    for name in plan:
        h = st["tenants"][name]["metrics"]["latency"]["execute"]
        e2e["tenants"][name] = {"p50_ms": h["p50_s"] * 1e3,
                                "p99_ms": h["p99_s"] * 1e3,
                                "flushes": st["tenants"][name]["service"][
                                    "flushes"]}
    log(f"burst: {n_burst} fresh queries from {3 * FRONT_CLIENTS} client "
        f"threads ({FRONT_CLIENTS} each for web, bi (shared) and etl "
        f"(isolated)) in {wall:.3f} s = {e2e['qps']:.2f} q/s; request "
        f"latency p50 {e2e['p50_ms']:.3f} ms, p99 {e2e['p99_ms']:.3f} ms "
        f"(host clock around urlopen; {smi}); every response 200 with kind "
        f"answer; flushes by size ({{size: flushes}}) shared "
        f"{sizes['shared']}, isolated {sizes['iso']}, {sum(rounds)} scan "
        f"rounds ({sum(rounds) / len(rounds):.2f} a flush); launches K1 "
        f"{counts['fused_masked_scan']} = the flushes' scan rounds, K2 "
        f"{counts['gp_batch_infer']}, K3 {k3} (general "
        f"{counts['se_cov_matrix']}, Gram {counts['se_cov_gram']}); "
        f"pre-screened {len(prescreened)}")
    log("  tenants' histograms (/v1/stats, log2 buckets' lower edges): "
        + "; ".join(f"{n} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
                    f" in {v['flushes']} flushes"
                    for n, v in e2e["tenants"].items()))
    log(f"twins: the {len(flushes['shared'])} shared and "
        f"{len(flushes['iso'])} isolated flushes replayed in order through "
        f"execute_many, every HTTP answer bitwise the twin's after the JSON "
        f"round trip ({replay_s:.3f} s)")

    # 2. Shared learning: web's answers that meet the target, asked as bi.
    delta = cfg.report_delta
    met = [i for i in plan["web"] if i in flushed and all(
        Cell.from_dict(c).rel_error(delta) < FRONT_TARGET
        for c in got[i][1]["cells"])][:FRONT_SHARED_HITS]
    assert len(met) == FRONT_SHARED_HITS, len(met)
    hits_before = st["shared_intel"]["per_tenant"]["bi"]["hits"]
    # Quiesce every ingest thread (their covariance builds launch K3), so
    # the counters see what a hit launches.
    for sess in (web.session, etl.session, twin_shared, twin_iso):
        sess.drain()
    torch.cuda.synchronize()
    before = launch_counts()
    hit_ms = []
    for i in met:
        t = time.perf_counter()
        status, _, raw = _http(base, "/v1/tenants/bi/execute",
                               {"query": bodies[i]})
        hit_ms.append((time.perf_counter() - t) * 1e3)
        body = json.loads(raw)
        assert status == 200 and body["served_from"] == "cache:exact", body
        assert body["cells"] == got[i][1]["cells"], i
    torch.cuda.synchronize()
    assert launch_counts() == before, "a shared-tenant hit launched kernels"
    st = json.loads(_http(base, "/v1/stats")[2])
    hits = st["shared_intel"]["per_tenant"]["bi"]["hits"] - hits_before
    assert hits == FRONT_SHARED_HITS, hits
    e2e["hit_p50_ms"] = float(np.percentile(hit_ms, 50))
    log(f"shared learning: {FRONT_SHARED_HITS} of web's answers posted as "
        f"bi, each served_from cache:exact with web's cells bitwise, no "
        f"launch; bi's hits +{hits}; HTTP hit p50 {e2e['hit_p50_ms']:.3f} ms "
        f"against phase 7's in-process hit p50 {hit_p50_ms:.3f} ms")

    # 3. Stream and explain on the isolated tenant. ``Session.stream``
    # never consults the serve-path router (``replay_rounds`` takes the
    # improve route when it yields every round, as the reference does), so
    # the twin executes on that route too: its router stops switching.
    router = twin_iso.engine.intel.router
    router.config = dataclasses.replace(router.config, route_switching=False)
    stream_budget = {"target_rel_error": FRONT_TARGET}
    lines = []
    for i in range(n_burst, n_burst + FRONT_STREAMS):
        status, headers, raw = _http(base, "/v1/tenants/etl/stream",
                                     {"query": bodies[i],
                                      "budget": stream_budget})
        assert status == 200, (status, raw[:200])
        assert headers["Content-Type"] == "application/x-ndjson", headers
        assert headers["Transfer-Encoding"] == "chunked", headers
        nd = [json.loads(line) for line in raw.splitlines()]
        assert [r["final"] for r in nd] == (
            [False] * (len(nd) - 1) + [True]), nd
        want = twin_iso.execute(fresh[i], budget)
        assert nd[-1] == _wire_json(want), (
            f"stream of query {i}: the final line differs from the twin's "
            "execute")
        lines.append(len(nd))
    status, _, raw = _http(base, "/v1/tenants/etl/explain",
                           {"query": bodies[0]})
    plan_body = json.loads(raw)
    assert status == 200 and plan_body["kind"] == "plan", plan_body
    log(f"stream: {FRONT_STREAMS} fresh queries to etl's /stream, chunked "
        f"NDJSON of {lines} lines (one a round, only the last final), the "
        f"final line bitwise the isolated twin's execute; /explain 200 "
        f"kind plan (cache {plan_body['cache']}, route {plan_body['route']})")

    # 4. Admission and errors over the wire.
    tiny_q = {"query": bodies[-1]}
    s1, _, _ = _http(base, "/v1/tenants/tiny/execute", tiny_q)
    s2, h2, raw2 = _http(base, "/v1/tenants/tiny/execute", tiny_q)
    assert s1 == 200 and s2 == 429, (s1, s2)
    assert float(h2["Retry-After"]) > 0, h2
    assert json.loads(raw2)["reason"] == "rate_limit"
    s3, h3, raw3 = _http(base, "/v1/tenants/full/execute", tiny_q)
    assert s3 == 503 and json.loads(raw3)["reason"] == "queue_full", s3
    assert float(h3["Retry-After"]) > 0, h3
    s4, _, raw4 = _http(base, "/v1/tenants/web/execute", b"{not json")
    assert s4 == 400 and "invalid JSON" in json.loads(raw4)["error"], raw4
    s5, _, _ = _http(base, "/v1/tenants/web/execute",
                     {"query": {"aggs": []}})
    assert s5 == 400, s5
    s6, _, _ = _http(base, "/v1/tenants/ghost/execute", tiny_q)
    s7, _, _ = _http(base, "/v1/nope")
    s8, _, _ = _http(base, "/v1/tenants/web/delete", tiny_q)
    assert (s6, s7, s8) == (404, 404, 404), (s6, s7, s8)
    health_ms = []
    for _ in range(FRONT_HEALTHZ):
        t = time.perf_counter()
        status, _, raw = _http(base, "/v1/healthz")
        health_ms.append((time.perf_counter() - t) * 1e3)
        assert status == 200 and json.loads(raw) == {"ok": True}
    e2e["healthz_p50_ms"] = float(np.percentile(health_ms, 50))
    st = json.loads(_http(base, "/v1/stats")[2])
    for name, t in st["tenants"].items():
        m = t["metrics"]
        assert m["requests"] == (m["answered"] + m["degraded"] + m["failed"]
                                 + sum(m["rejected"].values())), (name, m)
    assert st["tenants"]["tiny"]["metrics"]["rejected"] == {"rate_limit": 1}
    assert st["tenants"]["full"]["metrics"]["rejected"] == {"queue_full": 1}
    log(f"admission and errors: tiny 200 then 429 (Retry-After "
        f"{h2['Retry-After']} s), full 503, malformed bodies 400, an "
        f"unknown tenant and routes 404; healthz p50 "
        f"{e2e['healthz_p50_ms']:.3f} ms over {FRONT_HEALTHZ} round trips "
        "(the transport alone); every tenant's requests = answered + "
        "degraded + failed + rejected")

    # 5. Shutdown: no handler thread left.
    server.shutdown()
    server.server_close()
    deadline = time.perf_counter() + 10.0
    while _handler_threads() and time.perf_counter() < deadline:
        time.sleep(0.05)
    left = _handler_threads()
    assert not left, [t.name for t in left]
    for sess in (web.session, etl.session, twin_shared, twin_iso):
        sess.drain()
    e2e["seconds"] = time.perf_counter() - t_phase
    log(f"server shut down, no handler thread left; phase 9 took "
        f"{e2e['seconds']:.1f} s")
    return e2e


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
    cells' beta^2 (``beta2``; where it came from in ``beta2_at``) and their
    95% half-widths (``half_width``), of the other cells' estimates over
    their 95% half-width (``other_ci``), of the decisions' inputs
    (``stop``, ``theta``), the number of queries whose cells were compared
    (``n``) and the flips (``flips``)."""
    from repro_torch.utils.stats import confidence_multiplier

    a_r = float(confidence_multiplier(cfg.report_delta))
    d = dict(avg=0.0, other=0.0, beta2=0.0, half_width=0.0, other_ci=0.0,
             stop=0.0, theta=0.0, n=0, flips=[], beta2_at=None)
    for i, (a, b) in enumerate(zip(ra, rb)):
        if d["flips"]:  # states parted: record further flips only
            _decisions(a, b, i, cfg, target,
                       dict(d, stop=0.0, theta=0.0))  # shares d["flips"]
            continue
        _decisions(a, b, i, cfg, target, d)
        if d["flips"]:
            continue
        d["n"] += 1
        for j, (ca, cb) in enumerate(zip(a.cells, b.cells)):
            diff = abs(ca["estimate"] - cb["estimate"])
            rel = diff / max(abs(cb["estimate"]), 1e-300)
            b2 = abs(ca["beta2"] - cb["beta2"]) / max(cb["beta2"], 1e-300)
            if b2 > d["beta2"]:
                d["beta2"], d["beta2_at"] = b2, _beta2_cell(a, b, i, j)
            d["half_width"] = max(d["half_width"], abs(
                np.sqrt(ca["beta2"]) - np.sqrt(cb["beta2"])) / max(
                    np.sqrt(cb["beta2"]), 1e-300))
            if ca["kind"] == "AVG":
                d["avg"] = max(d["avg"], rel)
            else:
                d["other"] = max(d["other"], rel)
                d["other_ci"] = max(d["other_ci"], diff / max(
                    a_r * np.sqrt(cb["beta2"]), 1e-300))
    return d


def _beta2_cell(a, b, i, j):
    """Where a cell's beta^2 came from in two engines' answers to query
    ``i``: the cell, and for each snippet it reads (its AVG and FREQ rows)
    the synopsis key, the raw beta^2, both improved beta^2 and both
    ``accepted``."""
    from repro_torch.core.types import AVG

    gi, ai, kind, avg_row, freq_row = a.plan.cells[j]
    sa, sb = a.snippet_answer, b.snippet_answer
    rows = []
    for row in (avg_row, freq_row):
        if row < 0:
            continue
        agg = int(a.plan.snippets.agg[row])
        rows.append({
            "synopsis": (f"AVG measure {int(a.plan.snippets.measure[row])}"
                         if agg == AVG else "FREQ"),
            "raw_beta2": float(sb.raw_beta2[row]),
            "beta2": (float(sa.beta2[row]), float(sb.beta2[row])),
            "accepted": (bool(sa.accepted[row]), bool(sb.accepted[row]))})
    return {"query": i, "cell": j, "kind": kind,
            "group": a.plan.groups[gi], "beta2": (a.cells[j]["beta2"],
                                                  b.cells[j]["beta2"]),
            "snippets": rows}


def _log_compare(what, d):
    log(f"{what}: cells of {d['n']} queries compared, largest relative "
        f"difference AVG {d['avg']:.3e}, COUNT/SUM {d['other']:.3e} "
        f"({d['other_ci']:.3e} of their 95% half-width), beta^2 "
        f"{d['beta2']:.3e} (95% half-width {d['half_width']:.3e}); decision "
        f"inputs: largest relative error {d['stop']:.3e}, model theta "
        f"{d['theta']:.3e}; {len(d['flips'])} flipped decisions")
    if d["beta2_at"] is not None:
        log(f"  largest beta^2 difference at {d['beta2_at']}")
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
    # Decisions are compared on all queries. A flip passes only where its
    # input lay within FLIP_FACTOR times the engines' largest difference of
    # that input on the agreed decisions; it is then recorded under ROADMAP
    # Queue 3.
    _hold_phase4(d)
    out = {"avg_rel": d["avg"], "count_sum_rel": d["other"],
           "count_sum_of_half_width": d["other_ci"], "beta2_rel": d["beta2"],
           "half_width_rel": d["half_width"],
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
    _hold_phase4(d2)
    out.update(refit_ls_rel=ls_rel, refit_avg_rel=d2["avg"],
               refit_count_sum_of_half_width=d2["other_ci"],
               refit_flips=len(d2["flips"]))
    return out


def against_plain_wide(seed):
    """Phase 4 on a relation past the widths one launch takes: 9 numeric
    dimensions and 9 measures, 600,000 rows. A CUDA engine (K1 for any
    width over two measure groups, K3 for any l) and a CPU engine answer
    200 warm-up and 20 served queries, refit with PHASE4_REFIT_STEPS (the
    CUDA engine through K3's any-l Gram forward with derivatives and its
    reduction) and answer 20 more; held to phase 4's rules before and
    after the refit. Then K3's any-l routes are checked at every shape the
    CUDA engine launched (check_k3_shapes). Returns the comparison, the
    CUDA engine's launches before the refit and in it, and the device time
    of K3's any-l routes at the shapes it launched most."""
    import collections

    import torch
    from repro_torch.aqp.workload import make_relation, make_workload
    from repro_torch.core.engine import EngineConfig, VerdictEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.se_covariance import ops as se

    log(f"== phase 4, wide: CUDA engine against the CPU engine, 600,000 rows,"
        f" {WIDE_REL['n_num']} numeric dims and {WIDE_REL['n_measures']} "
        "measures")
    cfg = EngineConfig(sample_rate=0.1, n_batches=10, capacity=2000,
                       seed=seed)
    rels = {None: make_relation(seed + 5, 600_000, **WIDE_REL),
            "cpu": make_relation(seed + 5, 600_000, **WIDE_REL, device="cpu")}
    schema = rels["cpu"].schema
    warm = make_workload(seed + 6, schema, 200)
    test = make_workload(seed + 7, schema, 20)
    test2 = make_workload(seed + 15, schema, 20)
    target = 0.02
    results, engines, launches = {}, {}, {}
    shapes = collections.Counter()  # K3's launches by (route, n_i, n_j, l)
    for device in (None, "cpu"):
        eng = VerdictEngine(rels[device], cfg, device=device)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.execute_many(warm)
        results[device] = [eng.execute(q, target_rel_error=target)
                           for q in test]
        eng.drain()
        counts = launch_counts()
        _assert_healthy(eng)
        log(f"{device or 'cuda'} engine: {time.perf_counter() - t0:.2f} "
            f"s, launches {counts}")
        if device is None:
            for k in ("fused_masked_scan", "gp_batch_infer",
                      "se_cov_matrix"):
                assert counts[k] > 0, counts
            launches["serve"] = counts
            shapes.update(se.launch_shapes)
        else:
            assert all(v == 0 for v in counts.values()), counts
        engines[device] = eng
    torch.cuda.synchronize()
    d = _compare(results[None], results["cpu"], cfg, target)
    _log_compare("wide: CUDA vs CPU", d)
    _hold_phase4(d)
    for device, eng in engines.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.refit(steps=PHASE4_REFIT_STEPS)
        counts = launch_counts()
        log(f"{device or 'cuda'} engine, wide: refit(steps="
            f"{PHASE4_REFIT_STEPS}) in {time.perf_counter() - t0:.2f} s, "
            f"launches {counts}")
        if device is None:
            for k in ("se_cov_gram", "se_cov_derivs", "se_cov_grad"):
                assert counts[k] > 0, counts
            launches["refit"] = counts
            shapes.update(se.launch_shapes)
        else:
            assert all(v == 0 for v in counts.values()), counts
    g_par, c_par = _params_of(engines[None].store), _params_of(
        engines["cpu"].store)
    assert g_par.keys() == c_par.keys()
    ls_rel = max(float(np.max(np.abs(np.exp(g_par[k][0]) - np.exp(c_par[k][0]))
                              / np.exp(c_par[k][0]))) for k in c_par)
    log(f"wide: fitted lengthscales, CUDA against CPU: largest relative "
        f"difference {ls_rel:.3e}")
    res2 = {dev: [eng.execute(q, target_rel_error=target) for q in test2]
            for dev, eng in engines.items()}
    for eng in engines.values():
        eng.drain()
        _assert_healthy(eng)
    d2 = _compare(res2[None], res2["cpu"], cfg, target)
    _log_compare("wide: CUDA vs CPU after refit", d2)
    _hold_phase4(d2)
    del engines
    log("wide: K3 launches by (route, n_i, n_j, l) in the CUDA engine's "
        "serving and refit: " + ", ".join(
            f"{k[0]} {k[1]}x{k[2]} l={k[3]}: {c}"
            for k, c in shapes.most_common(12)) + f" ({len(shapes)} shapes)")
    assert any(k[0] == "gram+derivs" for k in shapes), shapes
    timed = check_k3_shapes(shapes, rels[None].device)
    return {"avg_rel": d["avg"], "count_sum_of_half_width": d["other_ci"],
            "flips": len(d["flips"]), "queries_compared": d["n"],
            "refit_ls_rel": ls_rel, "refit_avg_rel": d2["avg"],
            "refit_count_sum_of_half_width": d2["other_ci"],
            "refit_flips": len(d2["flips"])}, launches, timed


def _hold_phase4(d):
    """Phase 4's rule: AVG cells within rtol 1e-8, COUNT and SUM within a
    tenth of their half-width, every cell's half-width within
    HALF_WIDTH_RTOL of the other engine's, a flip only where its input lay
    within FLIP_FACTOR of the engines' largest difference in that input."""
    assert d["n"] > 0
    assert d["avg"] <= 1e-8, d["avg"]
    assert d["other_ci"] <= 0.1, d["other_ci"]
    assert d["half_width"] <= HALF_WIDTH_RTOL, (d["half_width"],
                                                d["beta2_at"])
    allowed = {"batches_used": FLIP_FACTOR * d["stop"],
               "accepted": FLIP_FACTOR * d["theta"]}
    bad = [f for f in d["flips"] if f[4] > allowed[f[1]]]
    assert not bad, f"flips outside {allowed} of their threshold: {bad}"


# ------------------------------------------------------------------ phase 10
LM_ARCH = "qwen2.5-3b"  # the full-width, full-depth serving run
LM_PARAMS = 3_085_938_688  # count_params of qwen2.5-3b (6.17 GB in bf16)
LM_B, LM_PROMPT, LM_STEPS = 4, 512, 32  # prompts, prompt tokens, decode steps
LM_REPS = 3  # timed runs of each step (median)
# bfloat16 decode against the teacher-forced forward over the same tokens:
# every logit within 2**-4 of the forward's RMS logit (36 layers of bf16
# activations, each rounded at 2**-9, summed in another order by a
# one-token product than by the whole prompt's) plus 2**-7 of its own
# magnitude (the logits are a bf16 product, 8 significant bits, widened to
# float32: the input token's own logit is ~2048, where a bf16 ulp is 16).
LM_BF16_TOL = (2.0 ** -4, 2.0 ** -7)
# The port on the card against the port on the CPU, float32 with TF32 off:
# a full-width logit is a dot product of 2048-2560 terms whose absolute sum
# is ~35 times the logit (~1,600 for logits of ~45), so float32 (2**-23)
# leaves ~2e-4 between summation orders; atol 1e-3 allows 4 times that.
LM_F32_TOL = dict(rtol=1e-5, atol=1e-3)
LM_CUT = {"qwen2.5-3b": 2, "rwkv6-3b": 2, "hymba-1.5b": 5}  # full width, depth
LM_CPU_B, LM_CPU_S, LM_GEN = 2, 16, 16  # card-against-CPU prompts and steps
BF16_PEAK_FLOPS = 989e12  # H100 SXM data sheet, dense bf16


def _host_ms(fn, reps=LM_REPS):
    """Median host time of ``fn`` between two synchronisations (ms)."""
    import torch

    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def _hold_decisions(got, want, what):
    """Phase 4's rule for decisions: argmax equal wherever ``want``'s top-2
    margin exceeds FLIP_FACTOR times the largest |got - want|. Returns
    (largest difference, positions decided, positions)."""
    import torch

    diff = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > FLIP_FACTOR * diff
    flips = decided & (got.argmax(-1) != want.argmax(-1))
    assert not bool(flips.any()), (
        f"{what}: argmax differs at {int(flips.sum())} decided positions "
        f"(largest logit difference {diff:.4e})")
    return diff, int(decided.sum()), decided.numel()


def _lm_inputs(cfg, rng, b, s):
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
    ctx = enc = None
    if cfg.cross_attn:
        ctx = rng.normal(size=(b, cfg.cross_attn.n_ctx, cfg.d_model)
                         ).astype(np.float32)
    if cfg.enc_dec:
        enc = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return tokens, ctx, enc


def _lm_forward(cfg, params, tokens, ctx, enc, dev):
    """Teacher-forced logits (float32) of ``tokens`` on ``dev``."""
    import torch
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        tok = torch.as_tensor(tokens, device=dev)
        if cfg.enc_dec:
            ctx_t = T.encode(cfg, params, torch.as_tensor(enc, device=dev))
        else:
            ctx_t = None if ctx is None else torch.as_tensor(ctx, device=dev)
        return T.forward(cfg, params, tok, ctx_tokens=ctx_t)[0]


def _lm_full(seed, dev):
    """qwen2.5-3b at full width and depth in bf16: prefill and greedy
    decode held against the teacher-forced forward, then timed."""
    import torch
    from repro_torch import configs
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    cfg = configs.get(LM_ARCH)
    n = PM.count_params(cfg)
    weight_bytes = n * 2
    log(f"{LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.param_dtype}: {n:,} parameters "
        f"({weight_bytes / 1e9:.3f} GB)")
    assert n == LM_PARAMS, n
    log("allow_bf16_reduced_precision_reduction:",
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    torch.cuda.synchronize()
    log(f"init_params on the card: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    # a random prompt and a random continuation of LM_STEPS tokens
    seq_np = rng.integers(0, cfg.vocab, (LM_B, LM_PROMPT + LM_STEPS))
    prompt = seq_np[:, :LM_PROMPT]
    max_len = LM_PROMPT + LM_STEPS
    prefill = E.make_prefill_step(cfg, max_len=max_len, device=dev)
    serve = E.make_serve_step(cfg, device=dev)

    # Held: prefill's last logits and every decode step's, teacher-forced
    # on the continuation, against the forward over the same tokens. With
    # random tied embeddings each position's own input token has by far
    # the largest logit, so greedy tokens would only repeat the input:
    # argmax is compared with that column masked on both sides.
    with torch.inference_mode():
        seq = torch.as_tensor(seq_np, device=dev)
        last, caches = prefill(params, prompt)
        step_logits = [last]
        for i in range(LM_STEPS):
            pos = LM_PROMPT + i
            logits, caches = T.forward(cfg, params, seq[:, pos:pos + 1],
                                       mode="decode", caches=caches, pos=pos)
            step_logits.append(logits[:, -1])
        got = torch.stack(step_logits, 1)  # (B, STEPS + 1, V)
    want = _lm_forward(cfg, params, seq, None, None, dev)[:, LM_PROMPT - 1:]
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    scale = float(want.abs().max())
    rms = float(want.square().mean().sqrt())
    excess = (got - want).abs() - (LM_BF16_TOL[0] * rms
                                   + LM_BF16_TOL[1] * want.abs())
    diff = float((got - want).abs().max())
    own = seq[:, LM_PROMPT - 1:, None]  # each position's input token
    own_top = float((want.argmax(-1, keepdim=True) == own).float().mean())
    masked_diff, decided, total = _hold_decisions(
        got.scatter(-1, own, -1e30), want.scatter(-1, own, -1e30),
        f"{LM_ARCH} decode")
    log(f"{LM_ARCH} decode against the forward over the same tokens: "
        f"{LM_STEPS} steps teacher-forced on a random continuation after a "
        f"{LM_B} x {LM_PROMPT} prefill, largest logit difference {diff:.4f} "
        f"(RMS logit {rms:.4f}, max |logit| {scale:.4f}; tolerance "
        f"{LM_BF16_TOL[0]:.4e} of the RMS plus {LM_BF16_TOL[1]:.4e} of each "
        f"|logit|, largest excess {float(excess.max()):.4f}); the input "
        f"token is the argmax at {own_top:.4f} of positions; with its column"
        f" masked (largest difference {masked_diff:.4f}), argmax equal at "
        f"{decided} of {total} decided positions")
    assert float(excess.max()) <= 0, float(excess.max())
    del got, want, excess, caches, step_logits

    def decode_run(b):  # greedy, for timing only
        last, c = prefill(params, prompt[:b])
        t = last.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_STEPS):
            t, c = serve(params, c, t, LM_PROMPT + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / LM_STEPS

    prefill_ms = _host_ms(lambda: prefill(params, prompt))
    decode_ms = {}
    for b in (LM_B, 1):
        decode_run(b)  # warm-up
        decode_ms[b] = float(np.median([decode_run(b)
                                        for _ in range(LM_REPS)]))
    peak = torch.cuda.max_memory_allocated()
    prefill_bound = 2 * n * LM_B * LM_PROMPT / BF16_PEAK_FLOPS * 1e3
    decode_bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{LM_ARCH} prefill, B = {LM_B} x {LM_PROMPT} tokens: "
        f"{prefill_ms:.3f} ms (bound {prefill_bound:.3f} ms by operations: "
        f"2 x {n} x {LM_B * LM_PROMPT} / {BF16_PEAK_FLOPS:.3e} FLOP/s)")
    for b in (LM_B, 1):
        log(f"{LM_ARCH} decode, B = {b}: {decode_ms[b]:.3f} ms a step, "
            f"{b * 1e3 / decode_ms[b]:.2f} tokens/s (bound {decode_bound:.3f}"
            f" ms a step by bytes: {weight_bytes} B of weights read once / "
            f"{HBM_BYTES_PER_S:.3e} B/s)")
    log(f"{LM_ARCH} peak device memory: {peak / 1e9:.3f} GB "
        f"(weights {weight_bytes / 1e9:.3f} GB)")
    return dict(prefill_ms=prefill_ms, prefill_bound_ms=prefill_bound,
                decode_ms_b4=decode_ms[LM_B], decode_ms_b1=decode_ms[1],
                decode_bound_ms=decode_bound,
                tokens_per_s_b4=LM_B * 1e3 / decode_ms[LM_B],
                tokens_per_s_b1=1e3 / decode_ms[1], peak_gb=peak / 1e9,
                decode_diff=diff, decode_rms=rms,
                decode_decided=[decided, total], decode_own_top=own_top)


def _lm_card_vs_cpu(seed, dev):
    """Full-width configs at cut depth in float32: the same weights on the
    card and on the CPU, forward logits and a greedy ``generate``; the
    chunked RWKV6 and Mamba mixers against their sequential oracles."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import mamba as M
    from repro_torch.models import params as PM
    from repro_torch.models import rwkv as R
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    worst = {}
    for arch, depth in LM_CUT.items():
        cfg = dataclasses.replace(configs.get(arch), n_layers=depth,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        t0 = time.perf_counter()
        # drawn on the card (a CPU draw of 0.2-0.5e9 normals takes seconds)
        card = PM.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        cpu = T.Decoder(cfg, card).to("cpu").tree()
        rng = np.random.default_rng(seed)
        tokens, ctx, enc = _lm_inputs(cfg, rng, LM_CPU_B, LM_CPU_S)
        got = _lm_forward(cfg, card, tokens, ctx, enc, dev).cpu()
        want = _lm_forward(cfg, cpu, tokens, ctx, enc, "cpu")
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_F32_TOL,
                                   err_msg=arch)
        diff = float((got - want).abs().max())
        gen_card = E.generate(cfg, card, tokens, LM_GEN, device=dev).cpu()
        gen_cpu = E.generate(cfg, cpu, tokens, LM_GEN, device="cpu")
        assert torch.equal(gen_card, gen_cpu), (arch, gen_card, gen_cpu)
        line = (f"{arch} at full width, {depth} layers, float32: card against"
                f" CPU forward logits largest difference {diff:.4e} (max "
                f"|logit| {float(want.abs().max()):.4f}), {LM_GEN} greedy "
                "tokens equal")
        if cfg.ssm is not None:  # the chunked mixer against its oracle
            # the first layer with a mixer of its own: rwkv6's first, and
            # hymba's second group (a sliding-window layer)
            gi = 0 if cfg.ssm.kind == "rwkv6" else 1
            lp = card["groups"][gi]["sub0"]["ssm"]
            if cfg.layer_plan()[gi][1] > 1:
                lp = PM.tree_map(lambda t: t[0], lp)
            s = 37 if cfg.ssm.kind == "rwkv6" else 23
            x = torch.as_tensor(rng.normal(size=(2, s, cfg.d_model)).astype(
                np.float32), device=dev)
            mix, ref = (R.rwkv6_mix, R.rwkv6_mix_ref) \
                if cfg.ssm.kind == "rwkv6" else (M.mamba_mix, M.mamba_mix_ref)
            with torch.inference_mode():
                a, b = mix(cfg, lp, x)[0], ref(cfg, lp, x)
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=arch)
            line += (f"; chunked {cfg.ssm.kind} against its sequential "
                     f"oracle on the card, S = {s}: largest difference "
                     f"{float((a - b).abs().max()):.4e}")
        log(line + f" ({time.perf_counter() - t0:.1f} s)")
        worst[arch] = diff
        del cpu, card
    return worst


def _lm_smoke_archs(seed, dev):
    """Every arch's smoke config on the card: decode against prefill."""
    import torch
    from repro_torch import configs
    from repro_torch.models import params as PM
    from repro_torch.serving import engine as E

    out = {}
    for arch in configs.names():
        cfg = configs.get_smoke(arch)
        params = PM.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        rng = np.random.default_rng(seed)
        tokens, ctx, enc = _lm_inputs(cfg, rng, LM_CPU_B, LM_CPU_S)
        s = LM_CPU_S
        full = _lm_forward(cfg, params, tokens, ctx, enc, dev)
        n_ctx = ctx.shape[1] if ctx is not None else (
            s if enc is not None else 0)
        prefill = E.make_prefill_step(cfg, max_len=s + cfg.meta_tokens + 4,
                                      n_ctx=n_ctx, device=dev)
        serve = E.make_serve_step(cfg, device=dev)
        last, caches = prefill(params, tokens[:, :s - 1], ctx_tokens=ctx,
                               enc_embeds=enc)
        np.testing.assert_allclose(last.cpu().numpy(),
                                   full[:, s - 2].cpu().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=arch)
        nxt, _ = serve(params, caches, tokens[:, s - 1:],
                       s - 1 + cfg.meta_tokens)
        assert torch.equal(nxt[:, 0].long(), full[:, s - 1].argmax(-1)), arch
        out[arch] = float((last - full[:, s - 2]).abs().max())
    log("smoke configs on the card, decode against prefill (last logits at "
        "rtol 2e-3 / atol 2e-3, the next token the teacher-forced argmax): "
        + ", ".join(f"{a} {d:.2e}" for a, d in out.items()))
    return out


def lm_serving(seed, smi):
    """Phase 10: the LM stack's serving path on the card."""
    import torch
    from repro_torch.core.types import resolve_device

    dev = resolve_device(None)
    log("== phase 10: LM serving (prefill, decode, generate) on the card")
    log(f"card: {smi}")
    t_phase = time.perf_counter()
    e2e = _lm_full(seed, dev)
    torch.cuda.empty_cache()
    assert not torch.backends.cuda.matmul.allow_tf32
    e2e["card_vs_cpu"] = _lm_card_vs_cpu(seed, dev)
    e2e["smoke_decode_vs_prefill"] = _lm_smoke_archs(seed, dev)
    e2e["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 took {e2e['seconds']:.1f} s")
    return e2e


# ------------------------------------------------------------------ phase 11
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 4, 512, 2  # microbatch rows, tokens, count
TRAIN_TIMED = 3  # timed steps, after one warm-up step
TRAIN_LR = 3e-4  # the trainer's default, under cosine_schedule as it sets it
# The fixed-batch check's constant lr: a bf16 update below half an ulp of
# its parameter vanishes (an ulp is 2**-8 at 0.5), so 1e-3 leaves most
# weights (scales 0.01-0.02) moving.
TRAIN_FIXED_LR = 1e-3
TRAIN_CPU_LR = 1e-3  # the card against the CPU, float32
ADAMW_BYTES = 24  # bf16 p, float32 g, m, v read; p, m, v written
# Card against CPU, one float32 step (TF32 off): the loss (~2,000: the
# input token's own logit, as in phase 10) within rtol 1e-5 (phase 10's
# logits part by up to 5.1e-3); grad_norm within rtol 1e-3 (gradients part
# by ~1e-6 of a leaf's largest value on the CPU against the reference, but
# hymba's fusion scalars cancel to 6e-5 of theirs); every parameter within
# TRAIN_STEP_BOUND lr: AdamW's first update of an element is lr * g /
# (|g| + eps), less than lr whatever g, so two runs part by under 2 lr;
# Adafactor's is linear in g, but a factored statistic that is itself
# rounding (the K bias's below) scales its noise up: held at the same 2 lr
# (its K bias parted by 0.25 lr, chip run, PR 24). Beyond atol 1e-6 /
# rtol 1e-5 at most 0.1% of all elements and, in a
# leaf, 3 or a quarter of its elements: an element whose gradient lies
# within a few eps of 0 takes an update that moves with its last bits; a
# fault in a leaf moves all of it. The K bias is held to the bound alone:
# under RoPE's low frequencies it adds nearly the same logit to every key
# of a query, which the softmax ignores, so most of its gradient cancels
# to rounding (54 of qwen2.5-3b's 512 elements part under AdamW, 129
# under Adafactor, whose column statistics then are rounding too).
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GNORM_RTOL = 1e-3
TRAIN_STEP_BOUND = 2.0
TRAIN_CPU_B, TRAIN_CPU_S = 2, 16


def _train_batch(cfg, pipe, shape, dev, rng=None):
    """The pipeline's next batch as (accum, B, S) tensors on ``dev``, with
    ctx / enc embeddings where the config takes them."""
    import torch

    toks, labels = pipe.next_batch()
    batch = {"tokens": torch.as_tensor(toks.reshape(shape), device=dev).long(),
             "labels": torch.as_tensor(labels.reshape(shape),
                                       device=dev).long()}
    rng = rng or np.random.default_rng(0)
    if cfg.cross_attn:
        batch["ctx"] = torch.as_tensor(rng.normal(
            size=shape[:2] + (cfg.cross_attn.n_ctx, cfg.d_model)).astype(
            np.float32), device=dev)
    if cfg.enc_dec:
        batch["enc"] = torch.as_tensor(rng.normal(
            size=shape + (cfg.d_model,)).astype(np.float32), device=dev)
    return batch


def _train_full(seed, dev):
    """qwen2.5-3b at full width and depth in bf16 with AdamW: one warm-up
    and three timed steps of 2 x 4 x 512 tokens, then three steps on one
    fixed batch at a constant lr, whose loss must fall."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import roofline
    from repro_torch.models import params as PM
    from repro_torch.training import adamw, make_train_step
    from repro_torch.training.optimizer import cosine_schedule

    cfg = configs.get(LM_ARCH)
    n = PM.count_params(cfg)
    assert n == LM_PARAMS, n
    tokens = TRAIN_ACCUM * TRAIN_B * TRAIN_S
    shape = (TRAIN_ACCUM, TRAIN_B, TRAIN_S)
    torch.cuda.reset_peak_memory_stats()
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    opt = adamw()
    state = opt.init(params)
    steps = 1 + TRAIN_TIMED
    sched = cosine_schedule(TRAIN_LR, warmup=max(steps // 10, 1),
                            total=steps)
    step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_S,
                         global_batch=TRAIN_B * TRAIN_ACCUM, seed=seed,
                         over_factor=1)
    losses, norms, ms = [], [], []
    for i in range(steps):
        batch = _train_batch(cfg, pipe, shape, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, sched(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), \
        (losses, norms)
    step_ms = float(np.median(ms[1:]))
    peak = torch.cuda.max_memory_allocated()
    model_flops = roofline.model_flops(cfg, "train", TRAIN_S,
                                       TRAIN_B * TRAIN_ACCUM)
    bound_6 = model_flops / roofline.PEAK_FLOPS * 1e3
    bound_8 = model_flops * 8 / 6 / roofline.PEAK_FLOPS * 1e3
    bound_adamw = ADAMW_BYTES * n / roofline.HBM_BW * 1e3
    log(f"{LM_ARCH} train step, bf16 AdamW, accum {TRAIN_ACCUM} x "
        f"{TRAIN_B} x {TRAIN_S} = {tokens} tokens, recomputation on: "
        f"warm-up {ms[0]:.3f} ms, timed {', '.join(f'{t:.3f}' for t in ms[1:])}"
        f" ms: {step_ms:.3f} ms a step (median), "
        f"{tokens * 1e3 / step_ms:.1f} tokens/s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}")
    log(f"{LM_ARCH} train step against its bounds: mfu {bound_6 / step_ms:.4f}"
        f" (6 N T = {model_flops:.4e} FLOP / {roofline.PEAK_FLOPS:.3e} FLOP/s"
        f" = {bound_6:.3f} ms), recomputed-forward share "
        f"{bound_8 / step_ms:.4f} (8 N T: {bound_8:.3f} ms), AdamW-bytes "
        f"share {bound_adamw / step_ms:.4f} ({ADAMW_BYTES} x {n} B / "
        f"{roofline.HBM_BW:.3e} B/s = {bound_adamw:.3f} ms); peak device "
        f"memory {peak / 1e9:.3f} GB")
    # three steps on one fixed batch at a constant lr: the loss falls
    fixed = _train_batch(cfg, pipe, shape, dev)
    fixed_losses = []
    for _ in range(3):
        params, state, m = step(params, state, fixed,
                                torch.tensor(TRAIN_FIXED_LR))
        fixed_losses.append(float(m["loss"]))
    log(f"{LM_ARCH} three steps on one fixed batch at lr {TRAIN_FIXED_LR}: "
        f"losses {', '.join(f'{x:.4f}' for x in fixed_losses)}")
    assert all(np.isfinite(fixed_losses)), fixed_losses
    assert fixed_losses[-1] < fixed_losses[0], fixed_losses
    del params, state, step
    return dict(step_ms=step_ms, warmup_ms=ms[0], timed_ms=ms[1:],
                tokens_per_s=tokens * 1e3 / step_ms, mfu=bound_6 / step_ms,
                share_8nt=bound_8 / step_ms,
                share_adamw_bytes=bound_adamw / step_ms,
                bound_6nt_ms=bound_6, bound_8nt_ms=bound_8,
                bound_adamw_ms=bound_adamw, peak_gb=peak / 1e9,
                losses=losses, grad_norms=norms, fixed_losses=fixed_losses)


def _clone_tree(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _tree_diff(a, b):
    """(largest |a - b| over the leaves, all leaves bitwise equal)."""
    import torch
    from repro_torch.models.params import tree_leaves

    worst, same = 0.0, True
    other = dict(tree_leaves(b))
    for path, x in tree_leaves(a):
        y = other[path]
        same = same and bool(torch.equal(x, y))
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst, same


def _train_determinism(seed, dev):
    """Phase 10's cut qwen2.5-3b (full width, 2 layers) in bf16: two steps
    from the same state on the same batch are bitwise equal."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params as PM
    from repro_torch.training import adamw, make_train_step

    cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=LM_CUT[LM_ARCH])
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_S,
                         global_batch=TRAIN_B * TRAIN_ACCUM, seed=seed,
                         over_factor=1)
    shape = (TRAIN_ACCUM, TRAIN_B, TRAIN_S)
    params, state, _ = step(params, state, _train_batch(cfg, pipe, shape,
                                                        dev),
                            torch.tensor(TRAIN_FIXED_LR))
    batch = _train_batch(cfg, pipe, shape, dev)
    runs = []
    for _ in range(2):
        p, s = _clone_tree(params), _clone_tree(state)
        p, s, m = step(p, s, batch, torch.tensor(TRAIN_FIXED_LR))
        runs.append((p, s, m))
    (p1, s1, m1), (p2, s2, m2) = runs
    p_diff, p_same = _tree_diff(p1, p2)
    s_diff, s_same = _tree_diff(s1, s2)
    same_loss = bool(torch.equal(m1["loss"], m2["loss"]))
    log(f"{LM_ARCH} at full width, {cfg.n_layers} layers, bf16: two steps "
        f"from one state on one batch: loss {float(m1['loss']):.6f} / "
        f"{float(m2['loss']):.6f} (bitwise {same_loss}), parameters bitwise "
        f"{p_same} (largest difference {p_diff:.3e}), optimizer state "
        f"bitwise {s_same} (largest difference {s_diff:.3e})")
    assert same_loss and p_same and s_same, (p_diff, s_diff)
    return dict(bitwise=True)


def _hold_step(got, want, lr, what):
    """Phase 11's rule for the parameters after one step (card against
    CPU), compared on the card. Returns (largest difference, loose
    elements, elements)."""
    from repro_torch.models.params import tree_leaves

    want = dict(tree_leaves(want))
    worst, n_loose, n = 0.0, 0, 0
    for path, t in tree_leaves(got):
        g = t.detach().float()
        w = want[path].to(g.device).float()
        d = (g - w).abs()
        bound = TRAIN_STEP_BOUND * lr + 1e-5 * w.abs()
        assert bool((d <= bound).all()), (what, path, float(d.max()))
        loose = int((d > 1e-6 + 1e-5 * w.abs()).sum())
        assert path.endswith("attn.bk") or \
            loose <= max(3, 0.25 * d.numel()), (what, path, loose, d.numel())
        worst, n_loose, n = max(worst, float(d.max())), n_loose + loose, \
            n + d.numel()
    assert n_loose <= 1e-3 * n, (what, n_loose, n)
    return worst, n_loose, n


def _train_card_vs_cpu(seed, dev):
    """Full-width configs at cut depth in float32: one accum-2 step with
    AdamW (and one with Adafactor on qwen2.5-3b), the same weights and
    batch on the card and on the CPU."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params as PM
    from repro_torch.training import adafactor, adamw, make_train_step

    out = {}
    cases = [(LM_ARCH, "adamw"), (LM_ARCH, "adafactor")] + [
        (a, "adamw") for a in LM_CUT if a != LM_ARCH]
    weights = {}
    for arch, name in cases:
        depth = LM_CUT[arch]
        cfg = dataclasses.replace(configs.get(arch), n_layers=depth,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        t0 = time.perf_counter()
        if arch not in weights:  # drawn on the card, copied to the CPU
            drawn = PM.init_params(cfg, generator=torch.Generator(
                device=dev).manual_seed(seed), device=dev)
            weights = {arch: (drawn, PM.tree_map(lambda t: t.cpu(), drawn))}
        card, cpu = (_clone_tree(t) for t in weights[arch])
        shape = (TRAIN_ACCUM, TRAIN_CPU_B, TRAIN_CPU_S)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_CPU_S,
                             global_batch=TRAIN_CPU_B * TRAIN_ACCUM,
                             seed=seed, over_factor=1)
        batch = _train_batch(cfg, pipe, shape, "cpu")
        metrics = {}
        for where, params, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            opt = adamw() if name == "adamw" else adafactor()
            step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
            b = {k: v.to(d) for k, v in batch.items()}
            _, _, m = step(params, opt.init(params), b,
                           torch.tensor(TRAIN_CPU_LR))
            metrics[where] = {k: float(v) for k, v in m.items()}
        got, want = metrics["card"], metrics["cpu"]
        assert np.isfinite(list(got.values())).all(), got
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=TRAIN_F32_LOSS_RTOL, err_msg=arch)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=TRAIN_F32_GNORM_RTOL, err_msg=arch)
        worst, loose, total = _hold_step(card, cpu, TRAIN_CPU_LR,
                                         f"{arch} {name}")
        log(f"{arch} at full width, {depth} layers, float32, one {name} step"
            f" (accum {TRAIN_ACCUM} x {TRAIN_CPU_B} x {TRAIN_CPU_S}, lr "
            f"{TRAIN_CPU_LR}): card against CPU loss {got['loss']:.6f} / "
            f"{want['loss']:.6f}, grad norm {got['grad_norm']:.6f} / "
            f"{want['grad_norm']:.6f}; parameters after the step: largest "
            f"difference {worst:.3e} (bound {TRAIN_STEP_BOUND} lr), "
            f"{loose} of {total} elements beyond atol 1e-6 / rtol 1e-5 "
            f"({time.perf_counter() - t0:.1f} s)")
        out[f"{arch} {name}"] = dict(loss=[got["loss"], want["loss"]],
                                     grad_norm=[got["grad_norm"],
                                                want["grad_norm"]],
                                     param_diff=worst, loose=[loose, total])
        del cpu, card
    return out


def _smoke_loss_and_grads(cfg, params, batch, remat):
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.train_loop import value_and_grad

    loss, grads = value_and_grad(
        cfg, params, batch, loss_fn=functools.partial(lm_loss, remat=remat))
    return loss, [g for _, g in tree_leaves(grads)]


def _train_smoke_archs(seed, dev):
    """Every smoke config on the card: accum 2 on [x, x] against accum 1
    on x, the loss finite and the parameters moving, recomputation on
    against off."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params as PM
    from repro_torch.training import adamw, make_train_step

    out = {}
    for arch in configs.names():
        cfg = configs.get_smoke(arch)
        params = PM.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_CPU_S,
                             global_batch=TRAIN_CPU_B, seed=seed,
                             over_factor=1)
        x = _train_batch(cfg, pipe, (1, TRAIN_CPU_B, TRAIN_CPU_S), dev)
        runs = {}
        for accum in (1, 2):
            p = _clone_tree(params)
            opt = adamw()
            b = {k: torch.cat([v] * accum) for k, v in x.items()}
            p, _, m = make_train_step(cfg, opt, accum=accum)(
                p, opt.init(p), b, torch.tensor(TRAIN_FIXED_LR))
            runs[accum] = (p, m)
        (p1, m1), (p2, m2) = runs[1], runs[2]
        assert np.isfinite(float(m1["loss"])), arch
        moved, _ = _tree_diff(p1, params)
        assert moved > 0, arch
        diff, same = _tree_diff(p1, p2)
        # two passes over one microbatch give the same gradient on the
        # card, and (g + g) / 2 = g exactly: equal within float32 rounding
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-6, err_msg=arch)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-6,
                                   err_msg=arch)
        assert diff <= 1e-6, (arch, diff)
        batch = {k: v[0] for k, v in x.items()}
        l_on, g_on = _smoke_loss_and_grads(cfg, params, batch, True)
        l_off, g_off = _smoke_loss_and_grads(cfg, params, batch, False)
        remat_same = bool(torch.equal(l_on, l_off)) and all(
            bool(torch.equal(a, b)) for a, b in zip(g_on, g_off))
        remat_diff = max(float((a - b).abs().max())
                         for a, b in zip(g_on, g_off))
        assert remat_diff <= 1e-6 * max(float(g.abs().max()) for g in g_on), \
            (arch, remat_diff)
        out[arch] = dict(loss=float(m1["loss"]), accum_bitwise=same,
                         accum_diff=diff, remat_bitwise=remat_same,
                         remat_diff=remat_diff)
    log("smoke configs on the card, one AdamW step (lr "
        f"{TRAIN_FIXED_LR}): accum 2 on [x, x] against accum 1 on x "
        "(parameters within 1e-6), recomputation on against off (gradients"
        " within 1e-6 of the largest): " + "; ".join(
            f"{a} loss {r['loss']:.3f}, accum "
            f"{'bitwise' if r['accum_bitwise'] else r['accum_diff']}, remat "
            f"{'bitwise' if r['remat_bitwise'] else r['remat_diff']}"
            for a, r in out.items()))
    return out


def _train_restart(seed, dev):
    """The trainer on the card: uninterrupted, and crashed after step 5
    then resumed, give the same final loss; a bf16 tree with its AdamW
    state round-trips a checkpoint on the card bit for bit."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch import train as TR
    from repro_torch.models import params as PM
    from repro_torch.training import adamw

    argv = ["--arch", LM_ARCH, "--smoke", "--steps", "8", "--batch", "2",
            "--seq", "16", "--accum", "1", "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory() as d:
        loss_a = TR.main(argv + ["--ckpt-dir", os.path.join(d, "a")])
        try:
            TR.main(argv + ["--ckpt-dir", os.path.join(d, "b"),
                            "--simulate-failure", "5"])
            raise AssertionError("--simulate-failure 5 did not stop")
        except SystemExit as e:
            assert e.code == 42, e.code
        loss_b = TR.main(argv + ["--ckpt-dir", os.path.join(d, "b")])
        log(f"trainer on the card ({LM_ARCH} smoke, 8 steps): uninterrupted "
            f"final loss {loss_a!r}, crashed after step 5 and resumed "
            f"{loss_b!r} (bitwise {loss_a == loss_b})")
        assert loss_a == loss_b, (loss_a, loss_b)

        cfg = dataclasses.replace(configs.get_smoke(LM_ARCH),
                                  param_dtype="bfloat16")
        params = PM.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        opt = adamw()
        state = opt.init(params)
        state["step"].fill_(3)
        PM.tree_map(lambda t: t.normal_(), state["m"])
        mgr = CheckpointManager(os.path.join(d, "bf16"))
        mgr.save_async(3, (params, state), {"step": 3})
        mgr.wait()
        target = (PM.tree_map(torch.zeros_like, params), opt.init(params))
        (got_p, got_s), _ = mgr.restore(target)
        _, p_same = _tree_diff(got_p, params)
        _, s_same = _tree_diff(got_s, state)
        bits = all(bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
                   for (_, a), (_, b) in zip(PM.tree_leaves(params),
                                             PM.tree_leaves(got_p)))
        ok = bits and p_same and s_same
        log(f"bf16 checkpoint on the card ({LM_ARCH} smoke parameters in "
            f"bf16 with an AdamW state): restored bit for bit {ok}")
        assert ok
    return dict(loss=loss_a, resumed=loss_b)


def lm_training(seed, smi):
    """Phase 11: the LM stack's training path on the card."""
    import torch
    from repro_torch.core.types import resolve_device

    dev = resolve_device(None)
    log("== phase 11: LM training (loss, AdamW / Adafactor, the train step, "
        "the trainer) on the card")
    log(f"card: {smi}")
    t_phase = time.perf_counter()
    e2e = _train_full(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    e2e["determinism"] = _train_determinism(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    assert not torch.backends.cuda.matmul.allow_tf32
    e2e["card_vs_cpu"] = _train_card_vs_cpu(seed, dev)
    e2e["smoke"] = _train_smoke_archs(seed, dev)
    e2e["restart"] = _train_restart(seed, dev)
    e2e["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 took {e2e['seconds']:.1f} s")
    return e2e


# ----------------------------------------------------------------- phase 12
TRACE_Q = (128, 4096)  # T005's snippet counts at the main path's block


def trace_layer(seed, smi):
    """Phase 12: the static checker's trace layer on the card."""
    from repro_torch.analysis.findings import ERROR, gate_count, render_text
    from repro_torch.analysis.programs import Program, sharded_mask_program
    from repro_torch.analysis.trace_rules import (
        check_improve_cache_cardinality, check_mask_build_collectives,
        check_no_tq_buffer, check_scan_launch_cache, cross_shard_ops,
        run_trace_rules)
    from repro_torch.aqp.executor import eval_partials
    from repro_torch.aqp.workload import tpch_like
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_masked_scan import ops as fms

    log("== phase 12: the static checker's trace layer (T001-T007) on the "
        "card")
    log(f"card: {smi}")
    t_phase = time.perf_counter()
    reset_launch_counts()
    found = run_trace_rules(device="cuda")
    out = {"rules_s": time.perf_counter() - t_phase}
    log(f"run_trace_rules(device='cuda') in {out['rules_s']:.2f} s:\n"
        f"{render_text(found)}")
    assert gate_count(found, strict=True) == 0, render_text(found)

    # T005 at the main path's shape: a block of an SF1 sample batch's size
    # (drawn as phase 2 draws K4's), the fused scan at Q = 128 and 4096.
    rel = tpch_like(seed, n_rows=600_000)
    rows = np.random.default_rng(seed + 7).permutation(rel.cardinality)
    blk = rel.take(rows[:SF1_BATCH_T])
    block = (blk.num_normalized, blk.cat, blk.measures)
    t_n = SF1_BATCH_T
    for q_n in TRACE_Q:
        s = _fused_snippets(rel, seed, 2000, q_n).to(rel.device)
        fused = Program("eval_partials_fused", fms.eval_partials_fused,
                        (*block, s), frozenset({"fused"}), t=t_n, q=q_n,
                        device=rel.device)
        bad = check_no_tq_buffer(fused)
        assert bad == [], render_text(bad)
        trace = fused.trace()
        limit = t_n * q_n * 8
        assert trace.peak_bytes < limit, (trace.peak_bytes, limit)
        assert trace.launches.get("fused_masked_scan", 0) > 0, trace.launches
        biggest = max((o.shape for r in trace.records for o in r.outputs),
                      key=lambda shp: int(np.prod(shp)))
        log(f"  T005 eval_partials_fused T={t_n} Q={q_n}: no (T, Q) tensor "
            f"(largest created {biggest}), peak memory delta "
            f"{trace.peak_bytes} B < T*Q*8 = {limit} B "
            f"({trace.peak_bytes / limit:.6f} of it), {len(trace.records)} "
            f"aten ops, launches {trace.launches}")
        out[f"t005_peak_bytes_q{q_n}"] = trace.peak_bytes
        out[f"t005_limit_bytes_q{q_n}"] = limit
    # The negative control: the plain scan under the fused tag, same block.
    q_n = TRACE_Q[0]
    s = _fused_snippets(rel, seed, 2000, q_n).to(rel.device)
    plain = Program("eval_partials_as_fused", eval_partials, (*block, s),
                    frozenset({"fused"}), t=t_n, q=q_n, device=rel.device)
    flagged = check_no_tq_buffer(plain)
    assert [(f.rule, f.severity) for f in flagged] == [("T005", ERROR)] * 2, (
        render_text(flagged))
    out["control_peak_bytes"] = plain.trace().peak_bytes
    log(f"  T005 negative control, eval_partials tagged fused T={t_n} "
        f"Q={q_n}: flagged (a (T, Q) tensor and the memory), peak memory "
        f"delta {out['control_peak_bytes']} B")
    del rel, blk, block, s, fused, plain

    # T007 keyed by K2's plan from the built library; K1's by shape.
    before = launch_counts()["gp_batch_infer"]
    assert check_improve_cache_cardinality(device="cuda") == []
    assert check_scan_launch_cache(device="cuda") == []
    log("  T007: the 4 x 4 (Q, fill) ladder gave one K2 signature (shapes "
        "and the built library's gp_plan) per bucket pair over "
        f"{launch_counts()['gp_batch_infer'] - before} K2 launches; K1's "
        "launch keyed by shape alone")
    # T003 over a four-shard mesh on the one card.
    p = sharded_mask_program("cuda", n_shards=N_SHARDS)
    assert len(set(p.trace().shards.values())) == N_SHARDS
    assert check_mask_build_collectives(p) == []
    assert not cross_shard_ops(p.trace())
    log(f"  T003: sharded_mask_build over {N_SHARDS} shards of the card "
        f"(T={p.t}): {len(p.trace().shards)} shard slices labelled, no "
        "cross-shard op")
    counts = launch_counts()
    log(f"  launches during phase 12: {counts}")
    out["launches"] = {k: counts[k] for k in ("fused_masked_scan",
                                              "masked_partials",
                                              "gp_batch_infer")}
    for k, n in out["launches"].items():
        assert n > 0, (k, counts)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 took {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 13
MOE_ARCH = "arctic-480b"  # one MoE layer at full width: 26.8 GB of experts
MOE_B, MOE_S = 2, 512  # tokens of the MoE layer's input
MOE_MESHES = ((2, 2), (1, 4))  # (data, model) over four positions of the card
MOE_RMS_ATOL = 2.0 ** -5  # tests/test_torch_lm_bf16.py's MoE tolerance
MOE_NEAR_TIE = 2.0 ** -6  # a top-k router logit this close to the next
MOE_TIE_ATOL = 2.0 ** -2  # ... holds its position at this fraction of RMS
COMP_B, COMP_S = 4, 512  # the compressed step's batch: 2 rows a pod
COMP_TIMED = 2  # timed compressed steps, after the checked one
COMP_LR = 1e-3
# The int8 bound of a mean of two dequantized values: each is within half
# its scale of its input, so their mean is within (s0 + s1) / 4 of the
# exact mean; 1e-4 of it covers the float32 rounding of x / scale, q *
# scale and the two sums (a few ulps of values up to 127 scales).
COMP_BOUND_SLACK = 1e-4
ELASTIC_LAYERS = 2  # qwen2.5-3b at full width and this depth for (c)


def _hold_moe(got, want, near_tie, what):
    """Phase 13's rule for a bf16 MoE output against its semantics: within
    MOE_RMS_ATOL of the output's RMS, positions routed at a near-tie within
    MOE_TIE_ATOL. Returns (largest difference over the RMS, near-ties)."""
    import torch

    rms = float(torch.sqrt(torch.mean(want.float() ** 2)))
    d = (got.float() - want.float()).abs().amax(-1).reshape(-1)
    tie = near_tie.reshape(-1)
    for sel, atol in ((~tie, MOE_RMS_ATOL), (tie, MOE_TIE_ATOL)):
        if bool(sel.any()):
            assert float(d[sel].max()) <= atol * rms, (what, float(d.max()),
                                                       rms)
    return float(d.max()) / rms, int(tie.sum())


def _moe_layer_params(cfg, seed, dev):
    """The MoE sub-tree of one layer of ``cfg`` (the reference's specs),
    drawn in bf16 on the card from a seed, scaled as ``init_params``."""
    import dataclasses

    import torch
    from repro_torch.models import params as PM

    spec = PM.param_specs(dataclasses.replace(cfg, n_layers=1))
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = PM.torch_dtype(cfg.param_dtype)

    def make(p):
        x = torch.randn(p.shape, generator=g, dtype=dtype, device=dev)
        return x.mul_(p.scale)

    return PM.tree_map(make, spec["groups"][0]["sub0"]["moe"])


def _moe_full(seed, dev):
    """(a) one arctic-480b MoE layer at its own capacity factor over
    (data, model) meshes of the card, against each batch shard's
    single-device MoE; two runs of one mesh bitwise."""
    import torch
    from repro_torch import configs
    from repro_torch.aqp.executor import Mesh
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import ffn as FF
    from repro_torch.models.common import ShardCtx, torch_dtype

    cfg = configs.get(MOE_ARCH)
    m = cfg.moe
    p = _moe_layer_params(cfg, seed, dev)
    n_expert_bytes = sum(p[w].numel() * p[w].element_size()
                         for w in ("we_g", "we_u", "we_d"))
    x = torch.randn((MOE_B, MOE_S, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(seed + 1), dtype=torch_dtype(
        cfg.compute_dtype), device=dev)
    n = MOE_B * MOE_S
    with torch.inference_mode():
        logits = (x.reshape(n, -1) @ p["router"]).float()
        top = torch.sort(logits, dim=-1, descending=True).values
        kth, nxt = top[:, m.top_k - 1], top[:, m.top_k]
        near_tie = (kth - nxt) <= MOE_NEAR_TIE * kth.abs()
        out = {"expert_gb": n_expert_bytes / 1e9, "tokens": n}
        for dp, tp in MOE_MESHES:
            mesh = Mesh((dev,) * (dp * tp), ("data", "model"), (dp, tp))
            sctx = ShardCtx(mesh=mesh)
            rows = MOE_B // dp
            want = torch.cat([FF.moe_ffn(cfg, p, x[i * rows:(i + 1) * rows])
                              for i in range(dp)])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runs, ms = [], []
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with H.record_collectives() as rec:  # read by phase 14
                    runs.append(FF.moe_ffn(cfg, p, x, sctx))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    heard = H.collective_bytes(rec)
            peak = torch.cuda.max_memory_allocated()
            assert torch.equal(runs[0], runs[1]), (dp, tp)
            assert bool(torch.isfinite(runs[0]).all())
            err, ties = _hold_moe(runs[0], want, near_tie, (dp, tp))
            cap = max(int(MOE_S * MOE_B // dp * m.top_k / m.n_experts
                          * m.capacity_factor), 4)
            log(f"{MOE_ARCH} MoE layer over (data {dp}, model {tp}) of the "
                f"card, bf16, {n} tokens, capacity {cap} an expert "
                f"(factor {m.capacity_factor}), {m.n_experts // tp} experts "
                f"a position: {ms[0]:.3f} / {ms[1]:.3f} ms (first / second "
                f"run, bitwise equal), largest difference from each batch "
                f"shard alone {err:.4e} of the RMS ({ties} near-tie "
                f"positions), peak memory {peak / 1e9:.3f} GB "
                f"({(peak - base) / 1e9:.3f} GB above the "
                f"{n_expert_bytes / 1e9:.3f} GB of experts and the inputs)")
            out[f"{dp}x{tp}"] = dict(ms=ms, err_rms=err, near_ties=ties,
                                     capacity=cap, peak_gb=peak / 1e9,
                                     peak_above_gb=(peak - base) / 1e9,
                                     collectives=heard)
            del runs, want
    del p, x
    return out


def _compressed_full(seed, dev):
    """(b) qwen2.5-3b at full width and depth, AdamW, over (pod 2, data 1,
    model 1) of the card: the int8 exchange's payloads, the mean the
    optimizer gets against the exact mean of the pods' float32 gradients,
    the loss against the pods' losses; then timed steps."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.aqp.executor import Mesh
    from repro_torch.distributed import compression as C
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import params as PM
    from repro_torch.training import adamw

    cfg = configs.get(LM_ARCH)
    n_params = PM.count_params(cfg)
    assert n_params == LM_PARAMS, n_params
    mesh = Mesh((dev,) * 2, ("pod", "data", "model"), (2, 1, 1))
    torch.cuda.reset_peak_memory_stats()
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_leaves = len(PM.tree_leaves(params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (1, COMP_B, COMP_S + 1))
    batch = {"tokens": torch.as_tensor(toks[..., :-1], device=dev),
             "labels": torch.as_tensor(toks[..., 1:], device=dev)}
    rec = {"losses": [], "exact": [], "calls": 0, "scales": None,
           "bytes": 0, "payload_leaves": 0, "checking": True}
    real_q, real_pp, real_acc = (C.quantize_int8, C.ppermute,
                                 C.accumulated_grads)

    def q_spy(x):
        # the exact mean of the pods' float32 gradients, built on the card
        # as pod 1's leaves arrive: (g0 + g1) / 2, leaf by leaf
        if rec["checking"]:
            j = rec["calls"] % n_leaves
            if rec["calls"] < n_leaves:
                rec["exact"].append(x.clone())
            else:
                rec["exact"][j].add_(x).div_(2)
            rec["calls"] += 1
        return real_q(x)

    def pp_spy(xs, mesh_, axis, perm):
        assert axis == "pod" and len(perm) == 2, (axis, perm)
        for src, _ in perm:
            for q, scale in xs[src]:
                assert q.dtype == torch.int8, q.dtype
                assert scale.dtype == torch.float32 and scale.numel() == 1
                rec["bytes"] += q.numel() * q.element_size() + 4
                rec["payload_leaves"] += 1
        rec["scales"] = [[float(s) for _, s in xs[i]] for i in range(2)]
        return real_pp(xs, mesh_, axis, perm)

    def acc_spy(*a, **kw):
        loss, grads = real_acc(*a, **kw)
        rec["losses"].append(float(loss))
        return loss, grads

    worst = {"ratio": 0.0, "abs": 0.0}
    opt = adamw()
    real_update = opt.update

    def update_spy(grads, state, params_, lr):
        if rec["checking"]:
            assert rec["calls"] == 2 * n_leaves, rec["calls"]
            s0, s1 = rec["scales"]
            for j, (_, g) in enumerate(PM.tree_leaves(grads)):
                bound = (s0[j] + s1[j]) / 4
                d = float((g - rec["exact"][j]).abs().max())
                rec["exact"][j] = None  # freed before the update runs
                worst["abs"] = max(worst["abs"], d)
                worst["ratio"] = max(worst["ratio"], d / bound)
                assert d <= bound * (1 + COMP_BOUND_SLACK), (j, d, bound)
        return real_update(grads, state, params_, lr)

    opt = dataclasses.replace(opt, update=update_spy)
    state = opt.init(params)
    C.quantize_int8, C.ppermute, C.accumulated_grads = q_spy, pp_spy, acc_spy
    try:
        # the checked step: no clipping, so the optimizer gets the mean
        checked = C.make_compressed_train_step(cfg, opt, mesh, clip_norm=1e30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with H.record_collectives() as rec_c:  # read by phase 14
            _, _, met = checked(params, state, batch, torch.tensor(COMP_LR))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        l0, l1 = rec["losses"]
        loss = float(met["loss"])
        assert abs(loss - (l0 + l1) / 2) <= 1e-6 * abs(loss), (loss, l0, l1)
        assert rec["payload_leaves"] == 2 * n_leaves
        assert rec["bytes"] == 2 * (n_params + 4 * n_leaves), rec["bytes"]
        exchanged = rec["bytes"]
        rec.update(checking=False, exact=[], losses=[], bytes=0)
        step = C.make_compressed_train_step(cfg, opt, mesh)
        ms, losses = [], []
        for i in range(COMP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, met = step(params, state, batch, torch.tensor(COMP_LR))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
    finally:
        C.quantize_int8, C.ppermute, C.accumulated_grads = (real_q, real_pp,
                                                            real_acc)
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)) and losses[-1] < loss, (loss, losses)
    step_ms = float(np.median(ms))
    log(f"{LM_ARCH} compressed train step, bf16 AdamW, (pod 2, data 1, model "
        f"1) of the card, {COMP_B} x {COMP_S} tokens ({COMP_B // 2} rows a "
        f"pod): checked step {first_ms:.3f} ms (the exact mean kept for the "
        f"check), timed {', '.join(f'{t:.3f}' for t in ms)} ms: "
        f"{step_ms:.3f} ms a step (median); losses {loss:.6f} (pods {l0:.6f},"
        f" {l1:.6f}), then {', '.join(f'{x:.6f}' for x in losses)}; the mean"
        f" the optimizer got within {worst['ratio']:.6f} of the int8 bound "
        f"(s0 + s1) / 4 at worst (largest difference {worst['abs']:.4e}); "
        f"{exchanged} bytes exchanged a step (int8 q, one byte a parameter, "
        f"and a float32 scale a leaf, {n_leaves} leaves, both ways), "
        f"{4 * 2 * n_params} as float32; peak device memory "
        f"{peak / 1e9:.3f} GB")
    del params, state, step, checked
    return dict(step_ms=step_ms, timed_ms=ms, checked_ms=first_ms,
                loss=loss, pod_losses=[l0, l1], losses=losses,
                bound_ratio=worst["ratio"], max_abs=worst["abs"],
                bytes_exchanged=exchanged, f32_bytes=4 * 2 * n_params,
                peak_gb=peak / 1e9, n_leaves=n_leaves,
                collectives=H.collective_bytes(rec_c))


def _elastic_full(seed, dev):
    """(c) qwen2.5-3b's parameters and AdamW state (full width, cut depth)
    placed under FSDP_RULES on (data 4, model 1), through a checkpoint,
    resharded onto (data 2, model 1): bitwise the originals."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.aqp.executor import Mesh
    from repro_torch.distributed import sharding as SH
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.elastic import reshard
    from repro_torch.models import params as PM
    from repro_torch.training import adamw

    cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=ELASTIC_LAYERS)
    params = PM.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    state = adamw().init(params)
    state["step"].fill_(3)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for k in ("m", "v"):
        PM.tree_map(lambda t: t.normal_(generator=g), state[k])
    tree = (params, state)
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in PM.tree_leaves(list(tree)))

    def shardings(data):
        mesh = Mesh((dev,) * data, ("data", "model"), (data, 1))
        ps = PM.shardings(cfg, mesh, SH.FSDP_RULES)
        return ps, SH.opt_state_shardings("adamw", ps, state)

    t0 = time.perf_counter()
    placed = SH.device_put(tree, shardings(4))
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(3, placed, {"step": 3})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = mgr.restore(placed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del placed
    t0 = time.perf_counter()
    moved = reshard(restored, shardings(2))
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    del restored
    got = SH.device_get(moved, dev)
    assert all(len(t.shards) == 2 for _, t in PM.tree_leaves(list(moved)))
    del moved
    same = True
    for (_, a), (_, b) in zip(PM.tree_leaves(list(got)),
                              PM.tree_leaves(list(tree))):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        same = same and bool(torch.equal(a, b))
    log(f"{LM_ARCH} at full width and {ELASTIC_LAYERS} layers: parameters "
        f"and AdamW state ({n_bytes / 1e9:.3f} GB) placed under FSDP_RULES "
        f"on (data 4, model 1) in {put_s:.3f} s, saved in {save_s:.3f} s, "
        f"restored in {restore_s:.3f} s, resharded onto (data 2, model 1) "
        f"in {reshard_s:.3f} s: bitwise the originals {same}")
    assert same
    del got, tree, params, state
    return dict(gb=n_bytes / 1e9, put_s=put_s, save_s=save_s,
                restore_s=restore_s, reshard_s=reshard_s)


def distributed_layer(seed, smi):
    """Phase 13: the distributed layer on the card."""
    import torch
    from repro_torch.core.types import resolve_device

    dev = resolve_device(None)
    log("== phase 13: the distributed layer (expert-parallel MoE, the int8 "
        "pod exchange, elastic re-placement) on the card")
    log(f"card: {smi}")
    t_phase = time.perf_counter()
    out = {"moe": _moe_full(seed, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["compressed"] = _compressed_full(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["elastic"] = _elastic_full(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 14
LAUNCH_REPS = 10  # timed calls of each probe on the card, after a warm-up
# The probes phase 14 runs on the card at their cells' shapes (single pod),
# with the cell's gradient accumulation (None: the cell's own, 16 over 16
# data shards, a micro batch of 16). qwen2.5-3b's layer vjp at micro 16
# ran out of the card's 79.2 GiB (66.7 GiB allocated, 16 GiB more asked:
# the float32 scores of 16 x 16 heads x 4096^2 are 17.2 GB a tensor, and
# the backward holds three of them beside the saved bf16 weights), so it
# runs at accum 32, a micro batch of 8: cut.
LAUNCH_PROBES = (("qwen2.5-3b", "decode_32k", "groups0_dec", None),
                 ("qwen2.5-3b", "train_4k", "groups0_fwd", None),
                 ("qwen2.5-3b", "train_4k", "groups0_vjp", 32),
                 ("rwkv6-3b", "train_4k", "ssm_chunk_fwd", None),
                 ("rwkv6-3b", "train_4k", "ssm_chunk_vjp", None))
# The decode probe's position: past the 32,784-slot ring, so that every
# slot is valid (``call_args`` fills slot positions with arange).
LAUNCH_DECODE_POS = 40_000
# Probe kinds phase 14 does not evaluate on meta, each seconds to minutes
# there (the CPU tests hold them against the reference over 8 positions):
# the whole model's vjp, the SSM archs' layer probes over a sequence (a
# Python loop of chunk steps, ~13 ms a step on meta) and the MoE archs'
# probes (a loop over all 256 or 512 positions, ~6 ms a position).
LAUNCH_SSM = ("rwkv6-3b", "hymba-1.5b")
LAUNCH_MOE = ("arctic-480b", "llama4-maverick-400b-a17b")


def _slow_on_meta(cell, label):
    if label == "microbatch_vjp" or cell.arch in LAUNCH_MOE:
        return True
    return (cell.arch in LAUNCH_SSM and cell.kind != "decode"
            and not label.startswith("ssm_chunk"))


def _tensor_leaves(tree):
    import torch
    from repro_torch.distributed.sharding import tree_map

    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor)
             else None, tree)
    return out


def _launch_cells(card_bytes):
    """(a) every cell over the abstract production meshes, its probes'
    outputs evaluated on meta (but ``_slow_on_meta``'s)."""
    from repro_torch.launch import cells as C
    from repro_torch.launch.mesh import make_production_mesh

    meshes = {mp: make_production_mesh(multi_pod=mp, device="meta")
              for mp in (False, True)}
    t0 = time.perf_counter()
    cells = [C.build_cell(arch, shape, meshes[mp], mp)
             for arch, shape in C.cell_list() for mp in (False, True)]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = skipped = 0
    fits = 0
    for cell in cells:
        arg_bytes = C.device_bytes(cell.args) + C.device_bytes(cell.kwargs)
        parts = []
        for label, mult, fn, args in cell.probes:
            if _slow_on_meta(cell, label):
                skipped += 1
                parts.append(f"{label} x{mult} (not run on meta)")
                continue
            outs = _tensor_leaves(fn(*C.call_args(args,
                                                  pos=LAUNCH_DECODE_POS)))
            assert outs and all(t.device.type == "meta" for t in outs)
            run += 1
            out_gb = sum(t.numel() * t.element_size() for t in outs) / 1e9
            parts.append(f"{label} x{mult} ({len(outs)} outputs, "
                         f"{out_gb:.3f} GB)")
        fit = arg_bytes <= card_bytes
        fits += fit
        pods = 2 if cell.meta["multi_pod"] else 1
        log(f"cell {cell.arch} {cell.shape} pods {pods}: {cell.kind}, "
            f"probes {'; '.join(parts) or 'none'}; arguments "
            f"{arg_bytes / 1e9:.3f} GB a position, "
            f"{'fits' if fit else 'does not fit'} the card's "
            f"{card_bytes / 1e9:.3f} GB")
    meta_s = time.perf_counter() - t0
    assert len(cells) == 66
    log(f"built {len(cells)} cells in {build_s:.3f} s; {run} probes "
        f"evaluated on meta in {meta_s:.3f} s, {skipped} not (the whole "
        f"model's vjp, the SSM archs' layer probes over a sequence, the MoE "
        f"archs' probes: seconds to minutes each on meta; held over 8 "
        f"positions by the CPU tests)")
    return dict(cells=len(cells), fit=fits, build_s=build_s,
                probes_on_meta=run, probes_not_on_meta=skipped,
                meta_s=meta_s)


def _flops(fn, args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def _launch_probe(arch, shape, label, accum, seed, dev):
    """(b) one probe at its cell's shapes on the card: FLOPs (the card's
    count equal to meta's), median time, the roofline bound of its FLOPs
    and of the bytes of its inputs and outputs, peak memory."""
    import torch
    from repro_torch.launch import cells as C
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import roofline

    cell = C.build_cell(arch, shape, make_production_mesh(device="meta"),
                        False, accum=accum)
    (fn, args), = [(p[2], p[3]) for p in cell.probes if p[0] == label]
    meta_flops, _ = _flops(fn, C.call_args(args, pos=LAUNCH_DECODE_POS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    real = C.call_args(args, dev, torch.Generator(device=dev).manual_seed(
        seed), pos=LAUNCH_DECODE_POS)
    ins = _tensor_leaves(real)
    in_bytes = sum(t.numel() * t.element_size() for t in ins)
    flops, out = _flops(fn, real)
    assert flops == meta_flops, (label, flops, meta_flops)
    outs = _tensor_leaves(out)
    assert all(bool(torch.isfinite(t).all()) for t in outs
               if t.is_floating_point()), label
    # outputs written into an input (the decode cache) are counted once
    held = {t.data_ptr() for t in ins}
    out_bytes = sum(t.numel() * t.element_size() for t in outs
                    if t.data_ptr() not in held)
    del out, outs
    ms = time_ms(lambda: fn(*real), reps=LAUNCH_REPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    r = roofline(flops, in_bytes + out_bytes, 0)
    bound_ms = r["step_time_lower_bound_s"] * 1e3
    del real, ins
    micro = cell.meta.get("micro")
    log(f"{arch} {shape} {label}" + (f" (micro {micro})" if micro else "")
        + f" on the card: {ms:.3f} ms (median of "
        f"{LAUNCH_REPS}), {flops} FLOPs (meta {meta_flops}), "
        f"{(in_bytes + out_bytes) / 1e9:.4f} GB in and out; bound "
        f"{bound_ms:.3f} ms ({r['dominant']}), {bound_ms / ms:.4f} of it "
        f"reached; peak memory {peak / 1e9:.3f} GB "
        f"({(peak - base) / 1e9:.3f} GB above what was allocated before)")
    return dict(ms=ms, flops=flops, meta_flops=meta_flops,
                bytes=in_bytes + out_bytes, bound_ms=bound_ms,
                dominant=r["dominant"], share=bound_ms / ms,
                peak_gb=peak / 1e9, micro=micro,
                mult=[p[1] for p in cell.probes if p[0] == label][0])


def _launch_collectives(e2e13):
    """(c) the crossings phase 13's calls reported, against the bytes it
    counted and the shapes' reckoning."""
    from repro_torch import configs
    from repro_torch.models.common import torch_dtype

    cfg = configs.get(MOE_ARCH)
    width = cfg.d_model * torch_dtype(cfg.compute_dtype).itemsize
    comp = e2e13["compressed"]
    pods = 2
    got = comp["collectives"]
    want = comp["bytes_exchanged"] // pods
    log(f"compressed step (phase 13), per position: {json.dumps(got)}")
    assert got["bytes_by_kind"]["collective-permute"] == want, (got, want)
    assert got["op_counts"]["collective-permute"] == 2 * comp["n_leaves"]
    assert got["bytes_by_kind"]["all-reduce"] == 4  # the loss' pmean
    out = {"compressed": got}
    for dp, tp in MOE_MESHES:
        heard = e2e13["moe"][f"{dp}x{tp}"]["collectives"]
        rows = MOE_B * MOE_S // dp
        log(f"{MOE_ARCH} MoE layer over (data {dp}, model {tp}) (phase 13), "
            f"per position: {json.dumps(heard)}")
        assert heard["bytes_by_kind"] == {"all-reduce": rows * width}
        assert heard["op_counts"] == {"all-reduce": 1}
        out[f"moe {dp}x{tp}"] = heard
    log(f"collective-permute bytes a pod of the compressed step "
        f"{got['bytes_by_kind']['collective-permute']:.0f} = phase 13's "
        f"{comp['bytes_exchanged']} bytes exchanged / {pods}")
    return out


def launch_layer(seed, smi, e2e13):
    """Phase 14: the launch layer (cells, probes, collective bytes)."""
    import torch
    from repro_torch.core.types import resolve_device

    dev = resolve_device(None)
    log("== phase 14: the launch layer (66 cells, five probes on the card, "
        "collective bytes of phase 13's calls)")
    log(f"card: {smi}")
    t_phase = time.perf_counter()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    out = {"cells": _launch_cells(card_bytes), "probes": {}}
    for i, (arch, shape, label, accum) in enumerate(LAUNCH_PROBES):
        out["probes"][f"{arch} {shape} {label}"] = _launch_probe(
            arch, shape, label, accum, seed + i, dev)
        gc.collect()
        torch.cuda.empty_cache()
    out["collectives"] = _launch_collectives(e2e13)
    out["card"] = smi
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {out['seconds']:.1f} s")
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
    k6 = check_k6(args.seed)
    wide = check_wide(rel, args.seed)
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
    e2e7 = workload_intelligence(rel, cfg, args.seed, smi)
    e2e8 = serving_service(rel, cfg, args.seed, smi)
    e2e9 = serving_front(rel, cfg, args.seed, smi, e2e7["hit_p50_ms"])
    del rel
    worst = against_plain(args.seed)
    worst_wide, wide_counts, k3_shapes = against_plain_wide(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    e2e10 = lm_serving(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    e2e11 = lm_training(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    e2e12 = trace_layer(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    e2e13 = distributed_layer(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    e2e14 = launch_layer(args.seed, smi, e2e13)
    for rec in [e2e13["compressed"]] + [e2e13["moe"][f"{dp}x{tp}"]
                                        for dp, tp in MOE_MESHES]:
        rec.pop("collectives")  # phase 14's line prints them
    serve_w, refit_w = wide_counts["serve"], wide_counts["refit"]

    def at(shape, rec):  # a kernel's record at a wide shape
        return {"shape": shape, **rec}

    kernels = [
        dict(name="fused_masked_scan", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K1_REPLACES, launches=counts["fused_masked_scan"],
             shape="T=60000 Q=128 f64", **k1[128],
             wide=at(f"T=60000 Q=128 M={WIDE_M} f64", wide["k1"])),
        # Every K1 launch of phase 4's wide engine (L = 9) takes this kernel.
        dict(name="fms_partials_any", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K1_REPLACES,
             launches=serve_w["fused_masked_scan"],
             shape=f"T=60000 Q=128 L={WIDE_REL['n_num']} "
                   f"M={WIDE_REL['n_measures']} f64", **wide["k1_any"]),
        # No driven path has a relation whose category sets outgrow a
        # block's shared memory: phase 2 alone launches this kernel.
        dict(name="fms_partials_stream", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K1_REPLACES, launches=0,
             shape=f"T=60000 Q=128 C=4 V={GLOBAL_V} M=2 f64",
             **wide["k1_global"]),
        dict(name="gp_batch_infer", route="cuda",
             source="src/repro_torch/csrc/gp_batch_infer.cu",
             replaces=K2_REPLACES, launches=counts["gp_batch_infer"],
             shape="Q=8 C=2000 f64", **k2[(8, "float64")]),
        dict(name="masked_partials", route="cuda",
             source="src/repro_torch/csrc/fused_masked_scan.cu",
             replaces=K4_REPLACES, launches=mesh_counts["masked_partials"],
             shape=f"T={SF1_BATCH_T} Q=128 f64", **k4[128],
             wide=at(f"T=60000 Q=128 M={WIDE_M} f64", wide["k4"])),
        dict(name="range_mask_agg", route="cuda",
             source="src/repro_torch/csrc/range_mask_agg.cu",
             replaces=K5_REPLACES, launches=k5_launches,
             shape=f"T={SF1_BATCH_T} Q=128 P=5 f32", **k5[5],
             wide=at(f"T={SF1_BATCH_T} Q=128 P={WIDE_P} f32", k5[WIDE_P])),
        dict(name="se_cov_matrix", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=counts["se_cov_matrix"],
             shape=f"128x{SYNOPSIS_C} l=3 f64",
             **k3[("general", 128, "float64")]),
        dict(name="se_cov_gram", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=counts["se_cov_gram"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l=3 f64",
             **k3[("gram", "float64")]),
        dict(name="se_cov_derivs", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_counts["se_cov_derivs"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l=3 f64 Gram",
             **k3["derivs"]),
        dict(name="se_cov_grad", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_counts["se_cov_grad"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l=3 f64", **k3["grad"]),
        # K3's kernels for any l: every K3 launch of phase 4's wide engine
        # (l = 9), its serving and its refit; timed at l = 12 and at the
        # shapes that engine launched most (l = 9). The general route is
        # se_cov_general_any (se_cov_any with derivatives).
        dict(name="se_cov_any_general", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES,
             launches=serve_w["se_cov_matrix"] + refit_w["se_cov_matrix"],
             shape=f"128x{SYNOPSIS_C} l={WIDE_L} f64", **wide["k3_general"]),
        dict(name="se_cov_any_gram", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES,
             launches=(serve_w["se_cov_gram"] + refit_w["se_cov_gram"]
                       - refit_w["se_cov_derivs"]),
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l={WIDE_L} f64",
             **wide["k3_gram"]),
        dict(name="se_cov_any_derivs", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_w["se_cov_derivs"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l={WIDE_L} f64 Gram",
             **wide["k3_derivs"]),
        dict(name="se_cov_any_reduce", route="cuda",
             source="src/repro_torch/csrc/se_covariance.cu",
             replaces=K3_REPLACES, launches=refit_w["se_cov_grad"],
             shape=f"{SYNOPSIS_C}x{SYNOPSIS_C} l={WIDE_L} f64",
             **wide["k3_reduce"], at_phase4_shapes=k3_shapes),
        # Every group-by probe of the cell takes the table route; the
        # sorted route (key spaces past a block's table) runs on no driven
        # path.
        dict(name="group_discovery", route="cuda",
             source="src/repro_torch/csrc/group_discovery.cu",
             replaces=K6_REPLACES, launches=counts["group_discovery"],
             shape=f"T={GD_T} P=1 table f64", **k6[(1, "table")],
             other_shapes=[at(f"T={GD_T} P={n} {r} f64", k6[(n, r)])
                           for n, r in ((16, "table"), (1, "sorted"),
                                        (16, "sorted"))]),
    ]
    log("library_ms is null for the fused masked scan and the fused GP "
        "improve: no single PyTorch call computes either; masked_partials' "
        "is one cuBLAS DGEMM, mask.T @ [m, m^2, 1]")
    log("launches: K1, K2 and K3's general and Gram forwards in phase 3's "
        "serve stream; K1's kernel for any width in phase 4's wide CUDA "
        "engine; K1 with streamed category words on no driven path (0); K4 "
        "in phase 5's mesh session; K5 over the SF1 "
        "batches; K3's forward with derivatives and its reduction in phase "
        f"6's refit (which also ran {refit_counts['se_cov_gram']} Gram "
        "forwards, derivatives included); K3's kernels for any l in phase "
        "4's wide CUDA engine, its serving and its refit (Gram launches "
        "without derivatives: all Gram launches less those with); K6 in "
        "phase 3's serve stream, one a group-by query")
    log(f"end to end: phase 3 {json.dumps(e2e)}; phase 6 {json.dumps(e2e6)}; "
        f"phase 5 {json.dumps(e2e5)}; phase 7 {json.dumps(e2e7)}; "
        f"phase 8 {json.dumps(e2e8)}; phase 9 {json.dumps(e2e9)};"
        f" CUDA vs CPU {json.dumps(worst)}; wide CUDA vs CPU "
        f"{json.dumps(worst_wide)}; phase 10 {json.dumps(e2e10)};"
        f" phase 11 {json.dumps(e2e11)}; phase 12 {json.dumps(e2e12)};"
        f" phase 13 {json.dumps(e2e13)}; phase 14 {json.dumps(e2e14)};"
        f" total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
