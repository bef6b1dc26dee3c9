"""Take the readings behind a cell's limits on the chip, in one process.

    python3 bench/tools/readings.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--mode sound|control|half_batch|...] \
        [--out readings.jsonl]

Each seed is a whole run of the cell (set-up, window, reference) through
``bench.harness.run``: ``sound`` as the benchmark runs it, ``control`` with
the control its configuration names (``bench.kinds.aqp.control_of``), or
one of the faults ``bench.kinds.aqp.FAULTS`` planted in the timed path. One JSON
line a run: the mode, the seed, the compared numbers, ``correct`` and the
end-to-end metrics.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="sound")
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    opts = ({} if args.mode == "sound" else {"control": True}
            if args.mode == "control" else {"fault": args.mode})
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        line = harness.run(args.workload, seed, args.seconds,
                           bool(args.trace), device="cuda", **opts)
        rec = {"mode": args.mode, "seed": seed, "correct": line["correct"],
               "checks": {k: v["value"] for k, v in line["checks"].items()},
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "attempted": line["attempted"], "failed": line["failed"],
               "info": line["info"], "wall_s": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
