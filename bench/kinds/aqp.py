"""Runner of an approximate-query cell: concurrent analysts through the
port's microbatching service.

Set-up draws the configuration's relation on the device from the seed,
opens the engine through ``repro_torch.verdict.connect``, builds the
kernels, runs the mix's warm-up through ``Session.execute_many`` in chunks
of the service's flush size and waits for ``drain()``. The window runs a
closed loop: each of the mix's clients submits its next query through
``Session.serve(...).submit`` only after ``Ticket.result()`` gave the last.
After the window the program's state is freed and the plain reference
(``bench.reference.aqp``) replays the engine's history and judges a sample
of the answers drawn from the seed.

Every number of the window is read on the host clock with nothing
synchronised. A traced run (``--trace 1``) goes on after the window for a
traced phase of its own: the calls into each layer are wrapped in spans
(``bench.trace.SpanLog``) that synchronise the device, as the port's smoke
script times its stages, and part of that phase is profiled. From the
program the runner reads only what it answered and its counters.

Besides the reference's numbers, ``correct`` holds the program to the
configuration's stop guarantee on every answer of the window that stopped
before the last sample batch (``stop_ratio``: its own largest 95% relative
bound over the target), and ``answer_gap`` ties those bounds to the
reference's.

The control of a cell (``control=True``) is named by its configuration's
``"control"``: ``"program_float32_improve"`` runs the port with its float32
improve (``use_kernels``); ``"reference_float32"``, for an engine without
learning, puts the plain reference computed in float32 in the program's
place for the judged answers.
"""
from __future__ import annotations

import gc
import importlib
import math
import os
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

from bench import querygen
from bench.reference import aqp as reference
from bench.trace import SpanLog, census, reduce_trace

JUDGED = 48  # answers the reference judges a run, drawn from the seed
JUDGE_STREAM = 2
TRACED_S = 20.0  # the traced phase after the window lasts this long
TRACE_LEAD_S = 2.0  # the profile starts this far into the traced phase
TRACE_MAX_S = 4.0  # and lasts at most this long (its trace is read whole)
PROFILES = 4  # profiles taken at most, one after another, until one reads
FAULTS = ("half_batch", "state_unchanged", "answer_altered", "stop_early")
CONTROLS = ("program_float32_improve", "reference_float32")


def faults_of(config: dict):
    """The faults a cell of ``config`` can have: an engine without learning
    keeps no state to leave unchanged."""
    learning = bool(config["engine"].get("learning", True))
    return tuple(f for f in FAULTS if learning or f != "state_unchanged")


def control_of(config: dict) -> str:
    c = config.get("control", CONTROLS[0])
    if c not in CONTROLS:
        raise ValueError(f"unknown control {c!r}; one of {CONTROLS}")
    return c


def _schema(config):
    from repro_torch.core.types import Schema

    s = config["schema"]
    return Schema(
        num_lo=tuple(float(c["lo"]) for c in s["numeric"]),
        num_hi=tuple(float(c["hi"]) for c in s["numeric"]),
        cat_sizes=tuple(int(c["size"]) for c in s["categorical"]),
        n_measures=len(s["measures"]),
        num_names=tuple(c["name"] for c in s["numeric"]),
        cat_names=tuple(c["name"] for c in s["categorical"]),
        measure_names=tuple(s["measures"]),
    )


def to_query(spec):
    """A ``QuerySpec`` as the port's ``AggQuery``."""
    from repro_torch.aqp import queries as Q

    return Q.AggQuery(
        aggs=tuple(Q.AggSpec(k, m) for k, m in spec.aggs),
        predicates=(tuple(Q.NumRange(d, lo, hi) for d, lo, hi in spec.ranges)
                    + tuple(Q.CatEq(d, v) for d, v in spec.eqs)),
        groupby=tuple(spec.groupby))


def judged_of(result, spec) -> reference.Judged:
    """What the program answered for one query (a ``QueryResult``): its
    cells and its raw snippet answers, keyed as the reference keys them."""
    from repro_torch.core.types import AVG, to_numpy

    cells = [(tuple(c["group"]), int(c["agg"]), c["kind"],
              float(c["estimate"]), float(c["beta2"])) for c in result.cells]
    raw = {}
    if result.plan is not None and result.snippet_answer is not None:
        _, _, cat, agg, mea = result.plan.snippets.numpy()
        rt = to_numpy(result.snippet_answer.raw_theta)
        rb = to_numpy(result.snippet_answer.raw_beta2)
        for i in range(len(agg)):
            group = tuple(int(np.flatnonzero(cat[i, d])[0])
                          for d in spec.groupby)
            is_avg = int(agg[i]) == AVG
            key = (group, "AVG" if is_avg else "FREQ",
                   int(mea[i]) if is_avg else 0)
            raw[key] = (float(rt[i]), float(rb[i]))
    return reference.Judged(cells, raw)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _plant(fault, eng=None, svc=None):
    """Break the timed path underneath, for the harness' own tests and the
    readings behind the limits (never in a measured run): the engine's
    faults from its start, the answers' once the service opens."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if fault == "half_batch" and eng is not None:
        evaluate = eng.scan.eval_block

        def half(block, snippets, local_eval=None):
            keep = np.arange(max(block.cardinality // 2, 1))
            return evaluate(block.take(keep), snippets, local_eval)

        eng.scan.eval_block = half
    elif fault == "state_unchanged" and eng is not None:
        eng.store.record = lambda snippets, raw: None
    elif fault == "stop_early" and svc is not None:
        svc.target_rel_error = math.inf  # every answer stops after a batch
    elif fault == "answer_altered" and svc is not None:
        run = svc._execute_slice

        def altered(queries):
            out = run(queries)
            for r in out:
                if r.cells:  # the first cell doubled
                    r.cells[0]["estimate"] *= 2.0
            return out

        svc._execute_slice = altered


def _spans(log: SpanLog, eng):
    """Wrap each layer's entry in a span; returns the undo."""
    from repro_torch.core import covariance
    from repro_torch.core.synopsis import Synopsis

    scan, improve, record = (eng.scan.eval_block, eng.store.improve_groups,
                             eng.store.record)
    eng.scan.eval_block = log.wrap("scan", scan, lambda block, s, *a, **k: {
        "t": int(block.num_normalized.shape[0]), "q": s.n,
        "l": int(s.lo.shape[1]), "c": int(s.cat.shape[1]),
        "v": int(s.cat.shape[2]), "m": int(block.measures.shape[1])})
    eng.store.improve_groups = log.wrap("improve", improve)
    eng.store.record = log.wrap("record", record)
    apply_add, factors = Synopsis._apply_add, covariance.numeric_factors
    Synopsis._apply_add = log.wrap("ingest", apply_add)
    covariance.numeric_factors = log.wrap("cov", factors, lambda bi, bj, p: {
        "n_i": bi.n, "n_j": bj.n, "l": int(bi.lo.shape[1]),
        "gram": bj is bi})

    def undo():
        del eng.scan.eval_block, eng.store.improve_groups, eng.store.record
        Synopsis._apply_add = apply_add
        covariance.numeric_factors = factors

    return undo


def run_cell(cell: dict, config: dict, mix: dict, limits: Dict[str, float],
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False,
             fault: Optional[str] = None) -> dict:
    """One run of an AQP cell. Returns ``{"run", "checks", "correct",
    "attempted", "failed", "device", "breakdown", "info"}``: ``run`` is
    what the metric readers read."""
    import torch
    from repro_torch import kernels
    from repro_torch import verdict as vd
    from repro_torch.aqp.relation import Relation

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    split, last = {}, [t_start]

    def lap(name):  # the set-up's parts, in seconds
        sync()
        last.append(time.perf_counter())
        split[name] = last[-1] - last[-2]

    lap("imports")
    if on_card:
        kernels.build()  # every stale source, one nvcc each, in parallel
    lap("build")
    data = importlib.import_module(f"bench.data.{config['generator']}")
    cols = data.make_columns(config, seed, device)
    lap("data")
    rel = Relation(schema=_schema(config), num=cols["num"], cat=cols["cat"],
                   measures=cols["measures"])
    engine_cfg = dict(config["engine"])
    if control and control_of(config) == "program_float32_improve":
        engine_cfg["use_kernels"] = True
    session = vd.connect(rel, vd.EngineConfig(**engine_cfg, seed=int(seed)))
    eng = session.engine
    _plant(fault, eng=eng)
    budget = vd.ErrorBudget(target_rel_error=float(mix["target_rel_error"]))
    n_batches = int(config["engine"]["n_batches"])
    lap("engine_and_sample")

    history = []  # (spec, batches_used) in the engine's order
    warm = querygen.warmup_stream(mix, config["schema"])
    todo, chunk = int(mix["warmup"]["queries"]), int(mix["warmup"]["chunk"])
    while todo > 0:
        specs = [warm.next() for _ in range(min(chunk, todo))]
        todo -= len(specs)
        answers = session.execute_many([to_query(s) for s in specs], budget)
        history += [(s, a.batches_used) for s, a in zip(specs, answers)]
    session.drain()
    lap("warmup")

    svc = session.serve(max_batch=int(mix["max_batch"]), budget=budget)
    _plant(fault, svc=svc)
    log = SpanLog(synchronise=True, sync=sync)
    slices, slice_errors = [], []
    execute = svc._execute_slice
    traced_execute = log.wrap("flush", execute,
                              lambda qs: {"queries": len(qs)})
    phase = {"traced": False}

    def spy(queries):
        t = time.perf_counter()
        traced = phase["traced"]
        if traced and "ta" not in window:  # the traced phase's first flush
            window["ta"] = t
        try:
            out = (traced_execute if traced else execute)(queries)
        except BaseException as e:  # noqa: BLE001 - kept, then re-raised
            slice_errors.append(repr(e))
            raise
        slices.append((t, time.perf_counter(), list(queries), out))
        return out

    svc._execute_slice = spy
    card = power_limit() if on_card else None
    if trace and on_card:
        _profiler_warmup()

    streams = querygen.client_streams(mix, config["schema"])
    timeout = float(mix["ticket_timeout_s"])
    records, window = [], {}
    gate = threading.Barrier(len(streams) + 1)

    def client(stream):
        gate.wait()
        while True:
            now = time.perf_counter()
            if now >= window["stop"]:
                return
            spec = stream.next()
            q = to_query(spec)
            try:
                ans = svc.submit(q).result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 - a failed query
                ans = e
            records.append({"spec": spec, "query": q, "submit": now,
                            "resolve": time.perf_counter(), "answer": ans})

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in streams]
    for t in threads:
        t.start()
    lap("service_and_clients")
    setup_s = time.perf_counter() - t_start
    kernels.reset_launch_counts()
    flushes0 = svc.flushes
    window["t0"] = time.perf_counter()
    window["t1"] = window["t0"] + float(seconds)
    window["stop"] = window["t1"] + (min(TRACED_S, float(seconds))
                                     if trace else 0.0)
    gate.wait()
    time.sleep(max(window["t1"] - time.perf_counter(), 0.0))
    counters = {"flushes": svc.flushes - flushes0,
                "launches": sum(kernels.launch_counts().values())}
    undo, trace_out, empty = (lambda: None), None, []
    if trace:  # the traced phase, after the window: spans synchronise
        undo = _spans(log, eng)  # a flush in flight keeps its spans out:
        phase["traced"] = True  # the phase starts with the next flush
        trace_out, empty = _profile(window, on_card, log)
        time.sleep(max(window["stop"] - time.perf_counter(), 0.0))
    for t in threads:
        t.join(timeout + 60.0)
    hung = sum(t.is_alive() for t in threads)
    undo()
    sync()
    session.drain()
    peak = torch.cuda.max_memory_allocated() if on_card else None

    flushes = [(t, t_end, len(q)) for t, t_end, q, _ in slices]
    started = {}
    for t, t_end, queries, out in slices:
        for q, r in zip(queries, out):
            started[id(q)] = (t, r, t_end)
    spec_of = {id(r["query"]): r["spec"] for r in records}
    for _, _, queries, out in slices:
        history += [(spec_of[id(q)], r.batches_used)
                    for q, r in zip(queries, out)]
    h_index = {}
    base = len(history) - sum(len(q) for _, _, q, _ in slices)
    for _, _, queries, _ in slices:
        for q in queries:
            h_index[id(q)] = base
            base += 1
    traced = ((window.get("ta", window["stop"]), window["stop"]) if trace
              else None)
    queries = []
    for r in records:
        ans = r["answer"]
        failed = (isinstance(ans, BaseException) or ans.failed
                  or bool(getattr(ans, "degraded", False)))
        st = started.get(id(r["query"]))
        queries.append({
            "submit": r["submit"], "resolve": r["resolve"],
            "latency_s": r["resolve"] - r["submit"],
            "in_window": r["resolve"] <= window["t1"],
            "in_traced": bool(traced) and traced[0] <= r["submit"]
            and r["resolve"] <= traced[1],
            "failed": failed,
            "start": st[0] if st else None, "end": st[2] if st else None,
            "batches_used": None if failed else ans.batches_used})

    ok = [r for r, q in zip(records, queries)
          if q["in_window"] and not q["failed"] and id(r["query"]) in h_index]
    z = reference.z_of(config["engine"]["report_delta"])
    target = float(mix["target_rel_error"])
    stop_ratio = max((stop_bound(started[id(r["query"])][1], z) / target
                      for r in ok
                      if r["answer"].batches_used < n_batches), default=0.0)
    rng = np.random.default_rng([int(seed), JUDGE_STREAM])
    pick = set(rng.choice(len(ok), size=min(JUDGED, len(ok)),
                          replace=False).tolist()) if ok else set()
    if ok:  # and the longest: most batches, then most cells
        pick.add(max(range(len(ok)), key=lambda i: (
            ok[i]["answer"].batches_used, len(ok[i]["answer"].cells))))
    judged = {h_index[id(ok[i]["query"])]: judged_of(
        started[id(ok[i]["query"])][1], ok[i]["spec"]) for i in pick}

    del svc, session, eng, rel, slices, started, records, ok
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if control and control_of(config) == "reference_float32":
        judged = _float32_answers(config, cols, int(seed), history, judged,
                                  n_batches)
    ref = reference.AqpReference(config, cols, int(seed))
    numbers = reference.check(ref, history, judged, target, n_batches)
    numbers["stop_ratio"] = stop_ratio
    info = numbers.pop("info")
    info["reference_s"] = time.perf_counter() - t_ref
    info["slice_errors"] = slice_errors[:3]
    info["hung_clients"] = hung
    info["setup_split_s"] = split
    info["window"] = window_summary(queries, flushes, window, counters)
    info["empty_profiles"] = empty
    if trace_out is not None:  # how well the trace's clock was placed
        info["trace_clock"] = {
            "drift_us": trace_out["clock_drift_us"],
            "spans_given_device_time": len(trace_out["span_device_s"])}
    attempted = sum(q["in_window"] for q in queries)
    failed = sum(q["in_window"] and q["failed"] for q in queries)
    checks = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    correct = (bool(judged) and not slice_errors and not hung
               and not any(q["failed"] for q in queries)
               and all(v <= lim for v, lim in checks.values()))
    run = {"window": (window["t0"], window["t1"]), "window_s": float(seconds),
           "traced": traced, "queries": queries, "flushes": flushes,
           "setup_s": setup_s,
           "counters": counters, "spans": log.done() if trace else None,
           "trace": trace_out}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "count": 1, "memory_peak_bytes": peak, "card": card}
    if trace_out is not None:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
    return {"run": run, "checks": checks, "correct": correct,
            "attempted": attempted, "failed": failed, "device": dev,
            "breakdown": (None if trace_out is None else {
                "device_ops": trace_out["device_ops"],
                "idle_gaps": trace_out["idle_gaps"]}),
            "info": info}


def _float32_answers(config, cols, seed, history, judged, n_batches):
    """The judged queries' answers from the plain reference in float32
    (true float32 products: TF32 off), in place of the program's."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ctl = reference.AqpReference(config, cols, seed, dtype=torch.float32)
        out = reference.raw_answers(ctl, history, judged, n_batches)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del ctl
    gc.collect()
    return out


def stop_bound(result, z: float) -> float:
    """The largest relative error bound among an answer's cells, as the
    program reported them: ``z * sqrt(beta2) / |estimate|``."""
    return max((z * math.sqrt(max(c["beta2"], 0.0))
                / max(abs(c["estimate"]), 1e-9) for c in result.cells),
               default=0.0)


def window_summary(queries, flushes, window, counters) -> dict:
    """Where a window query's latency went, on the host clock (means, in
    ms): submit to the start of the flush that ran it, that flush, and its
    end to the client's resolve; with the latency's percentiles and the
    window's flushes."""
    w = [q for q in queries if q["in_window"] and q["start"] is not None]
    if not w:
        return {}
    mean = lambda xs: 1e3 * float(np.mean(xs))  # noqa: E731
    lat = [q["latency_s"] for q in w]
    inside = [(t, e, n) for t, e, n in flushes
              if t >= window["t0"] and e <= window["t1"]]
    return {
        "queries": len(w), "flushes_counted": counters["flushes"],
        "flushes": len(inside),
        "flush_busy_s": float(sum(e - t for t, e, _ in inside)),
        "largest_flush": max((n for _, _, n in inside), default=0),
        "latency_ms": mean(lat),
        "latency_p50_ms": 1e3 * float(np.percentile(lat, 50)),
        "latency_p90_ms": 1e3 * float(np.percentile(lat, 90)),
        "queued_ms": mean([q["start"] - q["submit"] for q in w]),
        "flush_ms": mean([q["end"] - q["start"] for q in w]),
        "after_ms": mean([q["resolve"] - q["end"] for q in w]),
    }


def _profiler_warmup():
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's set-up) is not in the traced phase's profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _profile(window, on_card, log: SpanLog):
    """Profile a part of the traced phase from this thread:
    ``(reduce_trace``'s summary or None, ``census`` of each profile that
    gave nothing``)``. A profile that gives nothing is taken again, while
    the phase lasts, up to ``PROFILES`` in all."""
    span = window["stop"] - window["t1"]
    start = window["t1"] + min(TRACE_LEAD_S, 0.25 * span)
    length = min(TRACE_MAX_S, 0.5 * span)
    time.sleep(max(start - time.perf_counter(), 0.0))
    out, empty = None, []
    for _ in range(PROFILES):
        if out is not None or time.perf_counter() + length > window["stop"]:
            break
        out = _profile_once(on_card, log, length, empty)
    return out, empty


def _profile_once(on_card, log: SpanLog, length: float, empty: list):
    """One profile of ``length`` seconds. A marker kernel at each end
    places the trace's clock on the spans' host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    marks = []

    def mark():
        if on_card:
            a = time.perf_counter()
            torch.cuda._sleep(1000)
            marks.append((a, time.perf_counter()))

    log.retag()
    with profile(activities=acts) as prof:
        mark()
        log.tagging = on_card
        t = time.perf_counter()
        time.sleep(length)
        log.tagging = False
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        mark()
        if on_card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = reduce_trace(path, wall, log.done(), marks, log.tags)
        if out is None and on_card:
            empty.append(dict(census(path), marks=len(marks)))
        return out
    finally:
        os.unlink(path)
