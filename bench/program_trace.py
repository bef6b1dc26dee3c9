"""The port's own spans and counters, as a run keeps them, and the
reduction of a profiler trace by the spans' annotations.

The port records spans and counters where its work happens
(``repro_torch.utils.tracing``). A run that turns the recorder on keeps
them under ``run["program"]``:

- ``counters``: the counters over the window (read at its end, so that
  nothing the reference copies afterwards is counted);
- ``spans``: every span kept up to the traced phase's end, as tuples
  ``(id, parent, name, start, end, thread, request, attrs)`` on the host
  clock (``time.perf_counter``);
- ``trace``: ``reduce_annotated`` of the traced phase's profile, or None.

``reduce_annotated`` needs no marker and no clock offset: while a profile
records, each span the port opens is a ``user_annotation`` event named
``<name>#<id>`` on the thread that ran it, on the trace's clock, beside
that thread's CUDA launches. A kernel's device time goes to the innermost
annotation that holds its launch on the launching thread. The launch is
found through the kernel's ``External id``: the host event (an ATen
operator, or the annotation itself for a kernel launched outside any
operator) that was innermost on the launching thread, which carries that
thread's id. The CUDA runtime's own event is used only where a kernel has
none: its thread id is the profiler's cache by POSIX thread handle, which
can name an earlier thread that had the same handle.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional

from bench.trace import DEVICE_CATS, LAUNCH_CATS, MARKER, _merge, innermost

ID, PARENT, NAME, START, END, THREAD, REQUEST, ATTRS = range(8)
ANNOTATION = re.compile(r"^(?P<name>.+)#(?P<id>\d+)$")
HOST_CATS = ("cpu_op", "user_annotation")  # host events a kernel names
# Spans in which a thread waits rather than works: an idle gap is named by
# one of them only where no working span is open.
WAITS = ("service.lock_wait", "service.event_wait", "store.drain_wait")


# ------------------------------------------------------------ the readers
def program(run: dict) -> Optional[dict]:
    """``run["program"]``, or None where the run kept no program spans."""
    return run.get("program") or None


def window_queries(run: dict) -> int:
    """Queries resolved in the window: the base of every per-query
    metric, as of ``qps``."""
    return sum(1 for q in run["queries"] if q["in_window"])


def in_window(run: dict, name: str, **attrs) -> List[tuple]:
    """The program's spans named ``name`` (with the attributes given) that
    began and ended in the window."""
    prog = program(run)
    if prog is None:
        return []
    t0, t1 = run["window"]
    return [s for s in prog["spans"]
            if s[NAME] == name and t0 <= s[START] and s[END] <= t1
            and all(s[ATTRS].get(k) == v for k, v in attrs.items())]


def self_seconds(run: dict, spans: Iterable[tuple],
                 minus: Optional[Iterable[str]] = None) -> float:
    """Summed time of ``spans`` less that of their direct children (only
    those named in ``minus``, where given)."""
    spans = list(spans)
    ids = {s[ID] for s in spans}
    minus = None if minus is None else set(minus)
    kids = 0.0
    for s in program(run)["spans"]:
        if s[PARENT] in ids and (minus is None or s[NAME] in minus):
            kids += s[END] - s[START]
    return sum(s[END] - s[START] for s in spans) - kids


def per_query(run: dict, total: float, scale: float = 1.0):
    """``total`` × ``scale`` per window query; None without one."""
    n = window_queries(run)
    return scale * total / n if n else None


def per_flush(run: dict, total_s: float):
    """``total_s`` in ms per non-empty flush of the window; None without
    one."""
    n = len(in_window(run, "service.flush"))
    return 1e3 * total_s / n if n else None


# --------------------------------------------------------- the reduction
def _annotations(events) -> List[tuple]:
    """``(start_us, end_us, thread, name, id)`` of each program span the
    trace holds."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        m = ANNOTATION.match(e.get("name", ""))
        if m is not None:
            ts = float(e.get("ts", 0.0))
            out.append((ts, ts + float(e.get("dur", 0.0)), e.get("tid"),
                        m["name"], int(m["id"])))
    return out


def reduce_annotated(path: str, top: int = 10) -> Optional[dict]:
    """Read a Chrome trace written by ``torch.profiler`` with the port's
    span annotations: None where it holds no device activity or no
    annotation. Otherwise:

    - ``span_device_s``: {span id: device seconds of the kernels launched
      inside it and in none of its children};
    - ``spans``: {span id: [name, start_us, duration_us]} on the trace's
      clock, for each span the trace holds;
    - ``whole``: ``[first, last]`` (µs): from the start of the first
      ``service.flush`` the trace holds to the end of its last. Flushes
      run one at a time, so every span inside began after the profile did
      and is in the trace; ``flushes`` counts them;
    - ``device_s_by_span``: {name: device seconds} of the kernels launched
      inside ``whole``, given to the innermost span named;
    - ``held_device_s``, ``in_span_device_s``: device seconds of the
      kernels launched inside ``whole`` by a thread that holds program
      spans, and of those that a span holds;
    - ``end_us``: the end of the last span or device event the trace holds;
    - ``busy_s``, ``idle_gaps``: the union of device activity, and each gap
      between device work named by the innermost working span open at its
      middle (a waiting span where none works; ``outside_spans`` where
      none is open).
    """
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ann = _annotations(events)
    device, launches, hosts = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        corr, ext = args.get("correlation"), args.get("External id")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS and MARKER not in e.get("name", ""):
            device.append((ts, ts + dur, corr, ext))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, e.get("tid"))
        elif cat in HOST_CATS and ext is not None:
            hosts[ext] = (ts, e.get("tid"))
    if not device or not ann:
        return None
    flushes = [a for a in ann if a[3] == "service.flush"]
    whole = ((min(a[0] for a in flushes), max(a[1] for a in flushes))
             if flushes else None)
    by_thread: Dict[object, list] = {}
    for a in ann:
        by_thread.setdefault(a[2], []).append(a)
    pending: Dict[object, list] = {}  # thread -> [(launch ts, seconds)]
    for s, e, corr, ext in device:
        at = hosts.get(ext) or launches.get(corr)
        if at is not None and at[1] in by_thread:
            pending.setdefault(at[1], []).append((at[0], (e - s) * 1e-6))
    span_device: Dict[int, float] = {}
    by_name: Dict[str, float] = {}
    held = inside = 0.0
    for tid, items in pending.items():
        hits = innermost(by_thread[tid], [t for t, _ in items])
        for (t, sec), a in zip(items, hits):
            counted = whole is not None and whole[0] <= t <= whole[1]
            held += sec if counted else 0.0
            if a is None:
                continue
            span_device[a[4]] = span_device.get(a[4], 0.0) + sec
            if counted:
                inside += sec
                by_name[a[3]] = by_name.get(a[3], 0.0) + sec
    busy = _merge((s, e) for s, e, _, _ in device)
    mids = [(0.5 * (e0 + s1), (s1 - e0) * 1e-6)
            for (_, e0), (s1, _) in zip(busy, busy[1:])]
    work = [a for a in ann if a[3] not in WAITS]
    waits = [a for a in ann if a[3] in WAITS]
    gaps: Dict[str, float] = {}
    times = [m for m, _ in mids]
    for (_, sec), w, z in zip(mids, innermost(work, times),
                              innermost(waits, times)):
        label = (w or z or (None, None, None, "outside_spans"))[3]
        gaps[label] = gaps.get(label, 0.0) + sec
    return {
        "end_us": max([a[1] for a in ann] + [e for _, e, _, _ in device]),
        "span_device_s": span_device,
        "spans": {a[4]: [a[3], a[0], a[1] - a[0]] for a in ann},
        "whole": list(whole) if whole else None,
        "flushes": len(flushes),
        "device_s_by_span": by_name,
        "held_device_s": held,
        "in_span_device_s": inside,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "idle_gaps": [[n, t] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def clock_agreement(trace: Optional[dict], spans: Iterable[tuple]) -> dict:
    """How the trace's annotations sit against the host spans of the same
    ids: the spread (largest less smallest) and the distance between the
    quartiles of (trace start − host start) over every annotated span, in
    µs; and, over the spans that ended before the trace did (a span still
    open when the profile stopped is cut there), the median and the largest
    gap between a span's two durations."""
    if not trace:
        return {}
    host = {s[ID]: s for s in spans}
    pairs = []
    for sid, (_, ts, dur) in trace["spans"].items():
        s = host.get(int(sid))
        if s is not None:
            pairs.append((ts - 1e6 * s[START], dur, 1e6 * (s[END] - s[START]),
                          1e6 * s[END]))
    if not pairs:
        return {"spans_matched": 0}
    offs = sorted(p[0] for p in pairs)
    q = lambda f: offs[int(f * (len(offs) - 1))]  # noqa: E731
    gaps = sorted(abs(d - h) for off, d, h, end in pairs
                  if end + q(0.5) <= trace["end_us"])
    return {"spans_matched": len(pairs),
            "offset_spread_us": offs[-1] - offs[0],
            "offset_iqr_us": q(0.75) - q(0.25),
            "duration_gap_us_p50": gaps[len(gaps) // 2] if gaps else None,
            "duration_gap_us_max": gaps[-1] if gaps else None}
