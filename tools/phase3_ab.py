#!/usr/bin/env python3
"""Phase 3 of chip_smoke.py (the main path: TPC-H SF1 cardinality, a
2000-query warm-up, 200 queries served one by one, a 20-query profiler
window) for two checkouts of the repo in turn, A B B A, each run in a
process of its own on one NVIDIA GPU.

    python3 tools/phase3_ab.py DIR_A DIR_B [--seed N]

Each DIR holds a checkout (``chip_smoke.py`` and ``src/``), e.g. a ``git
archive`` of a parent commit unpacked beside this one; each builds its own
kernels on its first run. Prints every run's q/s, p50, p99 (ms) and device
idle share, then one JSON line with all runs. Host-clock numbers vary from
run to run (the machine's CPU cores are shared): compare the sides only
within one call, and only where the runs do not overlap.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

RUN = """
import json, os, sys
d = os.path.abspath(sys.argv[1])
os.chdir(d)
sys.path[:0] = [os.path.join(d, "src"), d]
import chip_smoke
chip_smoke.phase_build()
_, e2e, *_ = chip_smoke.main_path(int(sys.argv[2]))
print("PHASE3 " + json.dumps(e2e), flush=True)
"""


def run(where, seed):
    """One phase-3 run of the checkout at ``where``: its end-to-end record
    and idle share (None when the profiler saw no device activity)."""
    out = subprocess.run([sys.executable, "-c", RUN, where, str(seed)],
                         check=True, capture_output=True, text=True).stdout
    rec = json.loads(re.search(r"^PHASE3 (.*)$", out, re.M).group(1))
    idle = re.search(r"idle share ([0-9.]+)", out)
    rec["idle_share"] = float(idle.group(1)) if idle else None
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    runs = []
    for side in ("a", "b", "b", "a"):
        rec = run(getattr(args, side), args.seed)
        runs.append({"side": side, **rec})
        print(f"{side} ({getattr(args, side)}): {rec['qps']:.2f} q/s, p50 "
              f"{rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms, idle "
              f"share {rec['idle_share']}", flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
