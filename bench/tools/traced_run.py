"""Run a cell with the port's own spans and counters recorded, and read
the metrics that wait for them.

    python3 bench/tools/traced_run.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--trace 1] [--out runs.jsonl]

Each seed is one whole run of the cell through
``bench.kinds.aqp.run_cell``, as ``bench/run.py`` makes it. With
``--trace 1`` the port's recorder (``repro_torch.utils.tracing``) is on
from the window's start to the traced phase's end, and the profile of the
traced phase records every thread (the profiler's ``profile_all_threads``),
so that the spans of the service's client threads are annotated in it.
The cell's runner has no hook of its own for this, so the run is hooked
at three points it passes anyway: the reset of the launch counters (the
window's start: the recorder is reset and turned on), their read (the
window's end: the counters are taken) and the reduction of the profile
(``bench.program_trace.reduce_annotated`` reads the same trace). With
``--trace 0`` the run is the benchmark's untraced run, the recorder off.

One JSON line a run: the harness's metrics, the readers of
``PROGRAM_METRICS`` (``bench/metrics/<name>.py``) over the run's
``program`` record, and what holds the program's spans to the benchmark's
own records: flushes and their sizes against the benchmark's spy on
``AqpService._execute_slice``, the queue wait against ``queue_wait_ms``,
how much of each flush its child spans cover, which device time the
annotations hold, and how the annotations sit against the host spans.
"""
from __future__ import annotations

import argparse
import bisect
import functools
import importlib
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import program_trace as pt  # noqa: E402

PROGRAM_METRICS = ("lock_wait_ms", "empty_flushes_per_query",
                   "discover_ms_per_flush", "plan_ms_per_flush",
                   "replay_ms_per_query", "d2h_mb_per_query",
                   "host_syncs_per_query", "scan_device_ms_per_flush",
                   "improve_drain_wait_ms", "ingest_queue_wait_ms")


class _Hooks:
    """The three hooks of a traced run, undone by ``close``."""

    def __init__(self, kind):
        import torch
        from repro_torch import kernels
        from repro_torch.utils import tracing

        self.kind, self.kernels, self.tracing = kind, kernels, tracing
        self.counters, self.annotated = None, None
        self._undo = [(kernels, "reset_launch_counts",
                       kernels.reset_launch_counts),
                      (kernels, "launch_counts", kernels.launch_counts),
                      (torch.profiler, "profile", torch.profiler.profile),
                      (kind, "reduce_trace", kind.reduce_trace)]
        reset, counts, reduce = (kernels.reset_launch_counts,
                                 kernels.launch_counts, kind.reduce_trace)

        def window_start():
            reset()
            tracing.reset()
            tracing.enable()

        def window_end():
            if self.counters is None and tracing.enabled():
                self.counters = tracing.counters()
            return counts()

        def reduce_both(path, *a, **kw):
            out = reduce(path, *a, **kw)
            self.annotated = pt.reduce_annotated(path)
            return out

        every_thread = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        kernels.reset_launch_counts = window_start
        kernels.launch_counts = window_end
        torch.profiler.profile = functools.partial(
            torch.profiler.profile, experimental_config=every_thread)
        kind.reduce_trace = reduce_both

    def close(self):
        self.tracing.disable()
        for obj, name, value in self._undo:
            setattr(obj, name, value)


def _match_queued(run, queued):
    """(benchmark's, program's) queue wait in ms of each window query whose
    ``service.queued`` span is found: the span that ended where the query's
    flush began, whose start lies nearest the query's submit."""
    pairs = []
    spans = sorted(queued, key=lambda s: s[pt.END])
    ends = [s[pt.END] for s in spans]
    for q in run["queries"]:
        if not q["in_window"] or q.get("start") is None:
            continue
        i = bisect.bisect_left(ends, q["start"] - 5e-3)
        near = [s for s in spans[i:i + 64]
                if abs(s[pt.END] - q["start"]) < 5e-3]
        if near:
            s = min(near, key=lambda s: abs(s[pt.START] - q["submit"]))
            pairs.append((q["start"] - q["submit"], s[pt.END] - s[pt.START]))
    return pairs


def agreement(run) -> dict:
    """The program's spans held to the benchmark's records of the same
    window, and the flush's coverage by its child spans."""
    t0, t1 = run["window"]
    spy = [n for t, e, n in run["flushes"] if t >= t0 and e <= t1]
    flush = pt.in_window(run, "service.flush")
    sizes = [s[pt.ATTRS]["queries"] for s in flush]
    pairs = _match_queued(run, pt.in_window(run, "service.queued"))
    bench_q = [b for b, _ in pairs]
    prog_q = [p for _, p in pairs]
    total = sum(s[pt.END] - s[pt.START] for s in flush)
    out = {
        "spy_flushes": len(spy), "program_flushes": len(flush),
        "spy_queries_per_flush": statistics.fmean(spy) if spy else None,
        "program_queries_per_flush": (statistics.fmean(sizes) if sizes
                                      else None),
        "queued_matched": len(pairs),
        "queue_wait_ms_matched": (1e3 * statistics.fmean(bench_q)
                                  if pairs else None),
        "program_queued_ms_matched": (1e3 * statistics.fmean(prog_q)
                                      if pairs else None),
        "flush_uncovered_share": (pt.self_seconds(run, flush) / total
                                  if total else None),
    }
    n = pt.window_queries(run)
    names = sorted({s[pt.NAME] for s in run["program"]["spans"]})
    out["self_ms_per_query"] = {
        name: 1e3 * pt.self_seconds(run, pt.in_window(run, name)) / n
        for name in names} if n else {}
    return out


def attribution(run) -> dict:
    """What the annotated reduction gave the program's spans."""
    trace = run["program"].get("trace")
    if not trace:
        return {}
    whole = trace["whole"]
    blocks = [sid for sid, (name, ts, _) in trace["spans"].items()
              if name == "scan.block" and whole
              and whole[0] <= ts <= whole[1]]
    dev = trace["span_device_s"]
    return {
        "flushes": trace["flushes"],
        "scan_blocks": len(blocks),
        "scan_blocks_with_device_time": sum(dev.get(b, 0.0) > 0.0
                                            for b in blocks),
        "in_span_share": (trace["in_span_device_s"] / trace["held_device_s"]
                          if trace["held_device_s"] else None),
        "held_device_s": trace["held_device_s"],
        "device_s_by_span": trace["device_s_by_span"],
        "busy_s": trace["busy_s"],
        "idle_gaps": trace["idle_gaps"],
        "clock": pt.clock_agreement(trace, run["program"]["spans"]),
    }


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", bench=None, base: Path = harness.BENCH) -> dict:
    """One run of ``name``; the JSON record described above."""
    bench = bench or harness.benchmark()
    cell, config, mix, limits = harness.cell_parts(bench, name, base)
    kind = importlib.import_module(f"bench.kinds.{config['kind']}")
    hooks = _Hooks(kind) if trace else None
    try:
        out = kind.run_cell(cell, config, mix, limits, seed, seconds, trace,
                            device=device)
    finally:
        if hooks is not None:
            hooks.close()
    r = out["run"]
    metrics = {}
    for m in harness.metrics_of(bench, name, trace):
        v = harness.reader(m["name"], base)(r)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = v
    rec = {"workload": name, "seed": seed, "trace": int(trace),
           "correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics,
           "device": out["device"], "breakdown": out.get("breakdown")}
    if trace:
        end = r["traced"][1] if r["traced"] else math.inf
        r["program"] = {
            "counters": hooks.counters or {},
            "spans": [s for s in hooks.tracing.spans() if s[pt.END] <= end],
            "trace": hooks.annotated}
        hooks.tracing.reset()
        rec["program_metrics"] = {
            m: harness.reader(m, base)(r) for m in PROGRAM_METRICS}
        rec["counters"] = r["program"]["counters"]
        rec["agreement"] = agreement(r)
        rec["attribution"] = attribution(r)
    rec["info"] = {k: out["info"].get(k) for k in
                   ("window", "trace_clock", "empty_profiles",
                    "setup_split_s", "hung_clients", "slice_errors")}
    rec["checks"] = {k: v for k, (v, _) in out["checks"].items()}
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        rec = run(args.workload, seed, args.seconds, bool(args.trace))
        rec["wall_s"] = time.perf_counter() - t
        print(json.dumps(rec, default=str), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")


if __name__ == "__main__":
    main()
