"""Spans and counters recorded inside the port, off unless turned on.

A span is a timed stretch of work in one layer: its name, its start and
end on ``time.perf_counter()``, the native id of the thread that ran it,
its own id and the id of the span that was open around it on that thread,
a request id, and a few attributes (counts of queries, snippets and
tuples, or the label of a caller). A counter is a named running total.

    from repro_torch.utils import tracing

    with tracing.span("scan.block", tuples=t, snippets=q):
        ...
    tracing.count("service.empty_flush")

Nothing is recorded until ``enable()``; ``disable()`` stops it. While off,
a span site tests one module-level flag and gets back a shared no-op
context: no clock is read and nothing is kept. While on, spans go into a
bounded buffer (``CAPACITY`` spans; those past it are dropped and counted
under ``DROPPED``), read out with ``spans()``; counters are kept under one
lock, since the service's client threads, its flushes and the synopses'
ingest threads record at once, and read with ``counters()``. ``reset()``
empties both. Nothing is written out while spans are recorded.

Request ids: a span opened without one takes the id of the span open
around it, so every span under a query's replay carries that query's id,
and every span under a flush the ids of the queries it ran.

While a ``torch.profiler`` session records, each live span is also entered
as a ``record_function`` named ``<name>#<id>``. In the profiler's Chrome
trace it is then a ``user_annotation`` event on the thread that ran it and
on the trace's own clock, beside that thread's CUDA launches, so the device
work a span launched can be found without placing one clock on the other.
The profiler records other threads than its own only with the
``profile_all_threads`` setting of its experimental configuration.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18  # spans kept at most between two resets
DROPPED = "tracing.dropped_spans"  # counter of spans past the capacity

_on = False
_lock = threading.Lock()
_spans: List[tuple] = []
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Start recording spans and counters (into what is already kept)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was kept stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every kept span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def spans() -> List[tuple]:
    """The kept spans, in the order they ended: tuples ``(id, parent,
    name, start, end, thread, request, attrs)``. ``parent`` is 0 for a
    span opened with none around it; ``thread`` is the native thread id
    (the id a profiler trace gives the thread); ``attrs`` a dict."""
    with _lock:
        return list(_spans)


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def host_copy(x) -> None:
    """Count one copy of the tensor ``x`` from a CUDA device to the host
    (``host_copy.count``, ``host_copy.bytes``); nothing for a tensor
    already on the host, or while off."""
    if not _on or x.device.type != "cuda":
        return
    with _lock:
        _counters["host_copy.count"] = _counters.get("host_copy.count", 0) + 1
        _counters["host_copy.bytes"] = (_counters.get("host_copy.bytes", 0)
                                        + x.numel() * x.element_size())


def stamp() -> Optional[float]:
    """The span clock now while on, else None: the start of a span that
    ``record`` closes later, on another thread or in another call."""
    return time.perf_counter() if _on else None


def record(name: str, start: Optional[float], end: Optional[float] = None,
           request=None) -> None:
    """Keep a finished span from ``start`` (a ``stamp()``) to ``end``
    (default: now), with no parent: for waits that begin on one thread and
    end on another. Nothing while off or when ``start`` is None."""
    if not _on or start is None:
        return
    end = time.perf_counter() if end is None else end
    _keep((next(_ids), 0, name, start, end, _thread()[1], request, {}))


def _keep(sp: tuple) -> None:
    with _lock:
        if len(_spans) < CAPACITY:
            _spans.append(sp)
        else:
            _counters[DROPPED] = _counters.get(DROPPED, 0) + 1


def _thread() -> tuple:
    """This thread's (stack of open spans, native id), the id read once:
    reading it is a system call."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class _Null:
    """The context every span site gets while off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "request", "attrs", "id", "parent", "start",
                 "_stack", "_tid", "_annotation")

    def __init__(self, name, request, attrs):
        self.name = name
        self.request = request
        self.attrs = attrs

    def __enter__(self):
        stack, self._tid = _thread()
        self._stack = stack
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else 0
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(_ids)
        stack.append(self)
        self._annotation = None
        if getattr(_profiler, "_is_profiler_enabled", False):
            self._annotation = _profiler.record_function(
                f"{self.name}#{self.id}")
            self._annotation.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        self._stack.pop()  # spans close in the order they opened
        _keep((self.id, self.parent, self.name, self.start, end, self._tid,
               self.request, self.attrs))
        return False


def span(name: str, request=None, caller: Optional[str] = None,
         queries: Optional[int] = None, snippets: Optional[int] = None,
         tuples: Optional[int] = None):
    """A context that records one span named ``name`` while on (see the
    module docstring); the attributes given are kept by name."""
    if not _on:
        return _NULL
    attrs = {k: v for k, v in (("caller", caller), ("queries", queries),
                               ("snippets", snippets), ("tuples", tuples))
             if v is not None}
    return _Span(name, request, attrs)
