#!/usr/bin/env python3
"""Phase 9's HTTP burst on the card, in variants: which tenants post at
once, and the interpreter's thread switch interval.

    python3 tools/front_burst.py [--seed N] [--switch-ms 0.5]

Builds the kernels, then phase 9's relation and configuration (TPC-H SF1
``lineitem`` cardinality, ``EngineConfig(sample_rate=0.1, n_batches=10,
capacity=2000)``). For each variant it opens a fresh ``ServingFront`` with
phase 9's burst tenants that post in it (web and bi shared, etl isolated;
no rate limit, ``max_batch=64``, target 0.02), warms each engine with
phase 9's 200 queries, serves it with ``serve_http`` on 127.0.0.1 and posts
phase 9's fresh queries from ``FRONT_CLIENTS`` client threads a tenant
(``chip_smoke._front_burst``). Variants, in this order: all three tenants;
the shared tenants alone; the isolated tenant alone; all three with the
switch interval at ``--switch-ms``; all three again. Prints, per variant,
q/s, request latency p50 / p99 (host clock around the request) and the
flushes, after the card's name and power limit. It only times: phase 9 of
``chip_smoke.py`` holds the same burst's answers bitwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

SHARED = ("web", "bi")


def burst(rel, cfg, seed, names, switch_s):
    """One variant: a fresh front with ``names``, warmed, one burst."""
    from repro_torch.aqp.workload import tpch_workload
    from repro_torch.serving.front import ServingFront, TenantSpec, serve_http
    from repro_torch.verdict import ErrorBudget

    budget = ErrorBudget(target_rel_error=cs.FRONT_TARGET)
    warm = tpch_workload(seed + 40, rel.schema, cs.FRONT_WARM)
    fresh = tpch_workload(seed + 41, rel.schema, 3 * cs.FRONT_PER_TENANT)
    bodies = [cs._query_json(rel.schema, q) for q in fresh]
    front = ServingFront(rel, cfg, cache=True)
    for name in names:
        front.add_tenant(TenantSpec(
            name, isolation="shared" if name in SHARED else "isolated",
            rate=0, max_batch=64, budget=budget))
    engines = {}
    for name in names:
        sess = front.tenant(name).session
        engines.setdefault(id(sess.engine), sess)
    for sess in engines.values():
        sess.execute_many(warm)
        sess.drain()
    plan = {name: list(range(k * cs.FRONT_PER_TENANT,
                             (k + 1) * cs.FRONT_PER_TENANT))
            for k, name in enumerate(("web", "bi", "etl")) if name in names}
    server = serve_http(front)
    host, port = server.server_address
    old = sys.getswitchinterval()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
    try:
        got, lat, wall = cs._front_burst(f"http://{host}:{port}", plan,
                                         bodies)
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
        server.server_close()
    for sess in engines.values():
        sess.drain()
    assert all(s == 200 and b["kind"] == "answer" for s, b in got.values())
    ms = np.asarray(list(lat.values())) * 1e3
    stats = front.stats()["tenants"]
    return {"tenants": list(names), "queries": len(got),
            "switch_ms": (old if switch_s is None else switch_s) * 1e3,
            "qps": len(got) / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "flushes": {n: stats[n]["service"]["flushes"] for n in names}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--switch-ms", type=float, default=0.5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("front_burst: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.aqp.workload import tpch_like
    from repro_torch.core.engine import EngineConfig

    smi = cs.phase_build()
    rel = tpch_like(args.seed, n_rows=6_001_215)
    cfg = EngineConfig(sample_rate=0.1, n_batches=10, capacity=2000,
                       seed=args.seed)
    everyone = ("web", "bi", "etl")
    variants = [(everyone, None), (SHARED, None), (("etl",), None),
                (everyone, args.switch_ms / 1e3), (everyone, None)]
    for names, switch_s in variants:
        t0 = time.perf_counter()
        rec = burst(rel, cfg, args.seed, names, switch_s)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
