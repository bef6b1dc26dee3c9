#!/usr/bin/env python3
"""Where phase 4's beta^2 spread comes from, on the CPU alone.

    PYTHONPATH=src python3 tools/freq_cancellation.py [--rows N] [--seed N]
        [--threads A B]

Runs the CPU half of ``chip_smoke.py`` phase 4 (a ``tpch_like`` relation of
``--rows`` rows, its configuration, 200 warm-up queries, 20 served one by
one at ``target_rel_error=0.02``) once for each intra-op thread count,
compares the two runs with phase 4's own ``_compare`` and prints the cell
behind the largest beta^2 difference. For that cell's snippet it then
prints what the improve step computed in each run: the prior variance
kappa^2, the quadratic form k Sigma^-1 k^T, their difference gamma^2 (the
model's variance of the snippet, before the blend with the raw answer),
the improved beta^2 and the condition number of the synopsis' Sigma^-1.
Two summation orders of the quadratic form differ in the last bits; where
gamma^2 cancels most of kappa^2, those bits become percents of beta^2.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..")]


def run(rel, cfg, warm, test, threads):
    """Serve ``test`` after ``warm`` on a CPU engine with ``threads``
    intra-op threads; returns the results and, per test query, the improve
    calls' (kappa2, k Sigma^-1 k^T, gamma2, raw beta2, beta2, cond)."""
    import torch
    from repro_torch.core.engine import VerdictEngine
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops

    orig = gp_ops.gp_batch_infer
    calls = []

    def spy(k_mat, sinv, alpha, kappa2, mu, rawt, rawb, dtype=torch.float64,
            live=None):
        out = orig(k_mat, sinv, alpha, kappa2, mu, rawt, rawb, dtype=dtype,
                   live=live)
        n = sinv.shape[0] if live is None else live
        calls.append((kappa2.clone(), ((k_mat @ sinv) * k_mat).sum(1),
                      out[2].clone(), rawb.clone(), out[1].clone(),
                      float(torch.linalg.cond(sinv[:n, :n]))))
        return out

    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    gp_ops.gp_batch_infer = spy
    try:
        eng = VerdictEngine(rel, cfg, device="cpu")
        t0 = time.perf_counter()
        eng.execute_many(warm)
        results, per_query = [], []
        for q in test:
            calls.clear()
            results.append(eng.execute(q, target_rel_error=0.02))
            per_query.append(list(calls))
        eng.drain()
    finally:
        gp_ops.gp_batch_infer = orig
        torch.set_num_threads(old)
    print(f"{threads} thread(s): {time.perf_counter() - t0:.2f} s",
          flush=True)
    return results, per_query


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=600_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, nargs=2, default=(4, 1))
    args = ap.parse_args()
    import chip_smoke
    from repro_torch.aqp.workload import tpch_like, tpch_workload
    from repro_torch.core.engine import EngineConfig

    seed = args.seed
    cfg = EngineConfig(sample_rate=0.1, n_batches=10, capacity=2000,
                       seed=seed)
    rel = tpch_like(seed, n_rows=args.rows, device="cpu")
    warm = tpch_workload(seed + 2, rel.schema, 200)
    test = tpch_workload(seed + 3, rel.schema, 20)
    runs = [run(rel, cfg, warm, test, t) for t in args.threads]
    d = chip_smoke._compare(runs[1][0], runs[0][0], cfg, 0.02)
    chip_smoke._log_compare(f"{args.threads[1]} against {args.threads[0]} "
                            "thread(s)", d)
    at = d["beta2_at"]
    if at is None:
        return 0
    for snip in at["snippets"]:
        raw = snip["raw_beta2"]
        for threads, (_, per_query) in zip(args.threads, runs):
            hit = [c for c in per_query[at["query"]] if (c[3] == raw).any()]
            kappa2, quad, gamma2, _, beta2, cond = hit[-1]
            j = int((hit[-1][3] == raw).nonzero()[0])
            print(f"{snip['synopsis']} snippet, {threads} thread(s): kappa^2 "
                  f"{float(kappa2[j])!r}, k Sigma^-1 k^T {float(quad[j])!r}, "
                  f"gamma^2 {float(gamma2[j])!r} (kappa^2 / gamma^2 "
                  f"{float(kappa2[j] / gamma2[j]):.3e}), raw beta^2 {raw!r}, "
                  f"improved beta^2 {float(beta2[j])!r}, cond(Sigma^-1) "
                  f"{cond:.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
