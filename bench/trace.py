"""Spans, and the reduction of a profiler trace to what the readers need.

``SpanLog`` wraps calls into the program's layers from the benchmark's
side. In a traced run each span synchronises the device before and after,
so that its host time holds its device work; in an untraced run a span
only reads the host clock.

``reduce_trace`` reads the profiler's Chrome trace. The profiler records
every thread's CUDA runtime calls and device work, but the benchmark's
spans are on the host clock (``time.perf_counter``), so the trace clock is
placed on it by two marker kernels (``torch.cuda._sleep``) launched between
known host times at the profile's ends, and each thread that opens a span
while the profile runs launches one more, which names its trace thread. From there: the union of
device activity (busy time), device time by operation, the device time of
the kernels each span launched, and the idle gaps between device
activity, each given to the benchmark span the host was in.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep


class SpanLog:
    """Host-clock spans ``(layer, index, t0, t1, thread, attrs)``, written
    from any thread.

    While ``tagging`` is set (a profile is running), each thread's first
    span launches a marker kernel and keeps ``(before, after, thread)`` in
    ``tags``, so that the trace's thread of that launch can be named."""

    def __init__(self, synchronise: bool = False, sync=None):
        self.synchronise = synchronise
        self._sync = sync
        self.spans: List[tuple] = []
        self.tags: List[tuple] = []
        self.tagging = False
        self._tagged = set()
        self._lock = threading.Lock()

    def retag(self):
        """Forget the tags of an earlier profile: each thread tags again."""
        with self._lock:
            self._tagged.clear()
            self.tags.clear()

    def _tag(self):
        import torch

        me = threading.get_ident()
        with self._lock:
            if me in self._tagged:
                return
            self._tagged.add(me)
        a = time.perf_counter()
        torch.cuda._sleep(1)
        b = time.perf_counter()
        with self._lock:
            self.tags.append((a, b, me))

    def wrap(self, layer: str, fn, attrs=None):
        """``fn`` inside a span; ``attrs(*args, **kw)`` gives its attributes
        (shapes the readers count work from)."""
        log = self

        def run(*a, **kw):
            info = attrs(*a, **kw) if attrs else {}
            if log.tagging:
                log._tag()
            if log.synchronise:
                log._sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if log.synchronise:
                    log._sync()
                t1 = time.perf_counter()
                with log._lock:
                    log.spans.append((layer, len(log.spans), t0, t1,
                                      threading.get_ident(), info))

        return run

    def done(self) -> List[tuple]:
        return list(self.spans)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covering(spans, times):
    """For each of ``times``, the list of ``spans`` (``(start, end, ...)``)
    that hold it: one sweep over both in time order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    starts = sorted(spans, key=lambda sp: sp[0])
    out = [()] * len(times)
    active, j = [], 0
    for i in order:
        t = times[i]
        while j < len(starts) and starts[j][0] <= t:
            active.append(starts[j])
            j += 1
        if active and min(sp[1] for sp in active) < t:
            active = [sp for sp in active if sp[1] >= t]
        out[i] = tuple(active)
    return out


def innermost(spans, times):
    """For each of ``times``, the shortest of ``spans`` that holds it, or
    None."""
    return [min(c, key=lambda sp: sp[1] - sp[0]) if c else None
            for c in covering(spans, times)]


def reduce_trace(path: str, window_s: float, spans, marks, tags=(),
                 top: int = 10) -> Optional[dict]:
    """Read a Chrome trace written by ``torch.profiler``: ``None`` when it
    holds no device activity or no markers; else ``{"busy_s", "window_s",
    "device_ops", "idle_gaps", "span_device_s", "clock_drift_us"}``.

    ``spans``: ``SpanLog.done()``; ``marks``: the host times ``(before,
    after)`` around the marker launches at the profile's two ends;
    ``tags``: ``SpanLog.tags``. ``span_device_s`` = {span index:
    device seconds of the kernels launched inside it}."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, e.get("tid"))
    spins = sorted(launches[c] for _, _, n, c in device
                   if MARKER in n and c in launches)
    device = [d for d in device if MARKER not in d[2]]
    if not device or len(marks) != 2 or len(spins) < 2:
        return None
    ends = (spins[0], spins[-1])  # the profile's first and last launches
    # A launch call starts just after its host time ``a``; it may return
    # long after (the profile's first CUDA call can take milliseconds), so
    # the clocks are tied at ``a``, not at the bracket's middle.
    offs = [m[0] - 1e6 * a for m, (a, _) in zip(ends, marks)]
    off = sum(offs) / len(offs)
    host = [(t0 * 1e6 + off, t1 * 1e6 + off, tid, layer, idx)
            for layer, idx, t0, t1, tid, _ in spans]
    by_thread: Dict[object, list] = {}
    for sp in host:
        by_thread.setdefault(sp[2], []).append(sp)
    threads: Dict[object, list] = {}  # trace thread -> its host spans
    for ts, ktid in spins[1:-1]:  # each tag: the nearest host tag in time
        near = min(tags, key=lambda g: abs(1e6 * g[0] + off - ts),
                   default=None)
        if near is not None:
            threads[ktid] = by_thread.get(near[2], [])
    pending: Dict[object, list] = {}  # trace thread -> [(launch, seconds)]
    for s, e, _, corr in device:
        at = launches.get(corr)
        if at is not None:
            pending.setdefault(at[1], []).append((at[0], (e - s) * 1e-6))
    span_device: Dict[int, float] = {}
    for ktid, items in pending.items():
        hits = innermost(threads.get(ktid, []), [t for t, _ in items])
        for (_, sec), sp in zip(items, hits):
            if sp is not None:
                span_device[sp[4]] = span_device.get(sp[4], 0.0) + sec
    busy = _merge((s, e) for s, e, _, _ in device)
    by_op: Dict[str, float] = {}
    for s, e, name, _ in device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    mids = [(0.5 * (e0 + s1), (s1 - e0) * 1e-6)
            for (_, e0), (s1, _) in zip(busy, busy[1:])]
    gaps: Dict[str, float] = {}
    for (_, sec), sp in zip(mids, innermost(host, [m for m, _ in mids])):
        label = sp[3] if sp is not None else "outside_spans"
        gaps[label] = gaps.get(label, 0.0) + sec
    order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "device_ops": [[n, t] for n, t in order],
        "idle_gaps": [[n, t] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        "span_device_s": span_device,
        "clock_drift_us": max(offs) - min(offs),
    }


def census(path: str) -> dict:
    """What a Chrome trace holds, where ``reduce_trace`` read nothing: its
    events, device events, marker kernels and marker launches found."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    launches = {(e.get("args") or {}).get("correlation") for e in events
                if e.get("cat", "") in LAUNCH_CATS}
    device = [e for e in events if e.get("cat", "") in DEVICE_CATS]
    marks = [e for e in device if MARKER in e.get("name", "")]
    return {"events": len(events), "device": len(device),
            "markers": len(marks),
            "marker_launches": sum((e.get("args") or {}).get("correlation")
                                   in launches for e in marks)}


def in_traced(spans, run: dict, layer: str):
    """The spans of ``layer`` that lie inside the traced phase."""
    t0, t1 = run["traced"]
    return [s for s in spans if s[0] == layer and s[2] >= t0 and s[3] <= t1]


def roofline_share(run: dict, layer: str, work) -> Optional[float]:
    """Percent of the least time the card could take for the work of the
    traced ``layer`` spans, over the device time of what they launched;
    None where the trace gave those spans no device time."""
    from bench.roofline.peaks import least_seconds

    trace = run.get("trace")
    if not trace:
        return None
    dev = trace["span_device_s"]
    least = spent = 0.0
    for s in run["spans"]:
        if s[0] == layer and dev.get(s[1], 0.0) > 0.0:
            least += least_seconds(*work(**s[5]))
            spent += dev[s[1]]
    return 100.0 * least / spent if spent > 0.0 else None
