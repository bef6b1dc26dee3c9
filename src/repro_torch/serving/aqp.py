"""Microbatching AQP service: collect operator queries, flush one fused scan.

The serving-side counterpart of ``repro_torch.aqp.batch``: concurrent
dashboard clients submit ``AggQuery``s (or the facade's builders); the
service coalesces up to ``max_batch`` requests and executes them through a
``BatchExecutor`` under the service-wide error budget, so the relation's
sample batches are scanned once per flush instead of once per request.
Tickets resolve to ``QueryResult``s (or, through ``Session.serve``, typed
``QueryAnswer``s) after the flush.

The service is host code over the engine. On the card a flush's misses
launch what every fused workload launches: the fused scan kernel once per
scanned batch (the masked-partials kernel under ``mesh=``), the improve
kernel and the SE-covariance kernels; a query the answer cache serves at
``submit`` launches nothing.

Concurrency: the queue and ticket bookkeeping mutate only under the service
lock; the engine is driven under a separate execution lock (pass
``engine_lock=`` to share it between services whose engines share learned
state), and every ticket carries an event so ``Ticket.result()`` from one
thread waits correctly for a flush running on another. Every ticket
resolves exactly once (``Ticket.resolutions``).

Fault isolation: ``flush`` retries a failed fused execution with bounded
exponential backoff (a transient fault clears on retry), then BISECTS the
slice to isolate the poison query, which resolves as a typed
``FailedAnswer`` on its own ticket while every other ticket still gets its
real answer. A ``finally`` backstop guarantees no ticket hangs. A
per-query wall-clock ``deadline_s`` bounds response time: on expiry the
best-so-far answer returns with its honest wider CI, flagged ``degraded``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.aqp.batch import BatchExecutor, BatchStats
from repro_torch.aqp.queries import AggQuery
from repro_torch.ft import faults
from repro_torch.utils import tracing
from repro_torch.verdict.answer import FailedAnswer


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted query; resolved by the owning flush.

    The result is stored on the ticket itself, so a long-lived service
    retains nothing once callers drop their tickets. ``resolutions`` counts
    resolve calls: the exactly-once contract. While tracing is on
    (``repro_torch.utils.tracing``) the ticket keeps its submit time and
    its query's id, the request id of its spans.
    """

    _service: "AqpService"
    _result: object = None
    _done: bool = False
    resolutions: int = 0
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    _submitted: Optional[float] = None
    _request: Optional[int] = None

    def result(self, timeout: Optional[float] = None):
        """The query's answer (flushes the queue if still pending).

        If another thread's flush owns this ticket's batch, the local
        ``flush()`` finds an empty queue and this call waits on the
        ticket's event instead of returning a premature None.
        """
        if not self._done:
            self._service._flush("result")
        with tracing.span("service.event_wait", request=self._request):
            if not self._event.wait(timeout):
                raise TimeoutError("ticket unresolved after "
                                   f"{timeout}s (flush still in flight?)")
        return self._result

    def _resolve(self, result) -> None:
        self._result = result
        self.resolutions += 1
        self._done = True
        self._event.set()


class AqpService:
    """Thread-safe synchronous microbatcher over one ``VerdictEngine``.

    ``max_batch``: auto-flush threshold; ``target_rel_error`` /
    ``max_batches`` / ``stop_delta`` / ``deadline_s``: the error-budget
    contract applied to every flush; ``mesh``: an optional ``Mesh`` for
    the sharded scan (without one the engine's own placement);
    ``result_wrapper``: applied to every result before it lands on a
    ticket; ``max_retries`` / ``backoff_base_s`` / ``backoff_max_s``: the
    retry ladder; ``tenant``: a label for the workload-intel per-tenant
    counters; ``engine_lock``: one lock shared by every service over one
    engine, so engine execution (and the intel pre-screen, which mutates
    cache state) serializes across them.
    """

    def __init__(self, engine, max_batch: int = 64,
                 target_rel_error: Optional[float] = None, mesh=None,
                 max_batches: Optional[int] = None,
                 stop_delta: Optional[float] = None,
                 result_wrapper=None,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 2,
                 backoff_base_s: float = 0.01,
                 backoff_max_s: float = 0.5,
                 tenant: Optional[str] = None,
                 engine_lock: Optional[threading.Lock] = None):
        # A VerdictEngine, or a Session (its engine is served).
        self.engine = getattr(engine, "engine", engine)
        self.max_batch = int(max_batch)
        self.target_rel_error = target_rel_error
        self.max_batches = max_batches
        self.stop_delta = stop_delta
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.result_wrapper = result_wrapper
        self.tenant = tenant
        self.executor = BatchExecutor(self.engine, mesh=mesh)
        self._queue: List[tuple] = []  # (query, ticket) pairs
        # Queue and counter lock; never held across an engine call.
        self._lock = threading.Lock()
        # One flush (or pre-screen) drives the engine at a time.
        self._exec_lock = (engine_lock if engine_lock is not None
                           else threading.Lock())
        self.flushes = 0
        # Queries the answer cache resolved at submit(): they never entered
        # a microbatch.
        self.prescreened = 0
        self.last_stats: Optional[BatchStats] = None

    @property
    def pending(self) -> int:
        """Queries waiting for the next flush."""
        return len(self._queue)

    def submit(self, query) -> Ticket:
        """Enqueue one query; auto-flushes when the microbatch is full.

        Accepts an ``AggQuery`` or anything with ``.build()`` (the facade's
        ``QueryBuilder``). The append and the threshold check happen under
        one lock, so concurrent submitters neither lose an entry nor
        double-flush a batch.
        """
        submitted = tracing.stamp()
        if not isinstance(query, AggQuery) and hasattr(query, "build"):
            query = query.build()
        ticket = Ticket(self)
        if submitted is not None:
            ticket._submitted, ticket._request = submitted, id(query)
        # Workload-intelligence pre-screen: a cache hit resolves the ticket
        # at once and never occupies a microbatch slot. The lookup mutates
        # shared cache state, so it runs under the engine lock.
        intel = getattr(self.engine, "intel", None)
        if intel is not None:
            with self._exec_lock:
                served = intel.lookup(
                    self.engine, query,
                    target_rel_error=self.target_rel_error,
                    stop_delta=self.stop_delta, max_batches=self.max_batches,
                    tenant=self.tenant)
            if served is not None:
                if self.result_wrapper is not None:
                    served = self.result_wrapper(served)
                with self._lock:
                    self.prescreened += 1
                ticket._resolve(served)
                return ticket
        with self._lock:
            self._queue.append((query, ticket))
            full = len(self._queue) >= self.max_batch
        if full:
            self._flush("submit")
        return ticket

    def _execute_slice(self, queries: List[AggQuery]) -> List:
        return self.executor.execute_many(
            queries,
            target_rel_error=self.target_rel_error,
            max_batches=self.max_batches,
            stop_delta=self.stop_delta,
            deadline_s=self.deadline_s,
            tenant=self.tenant,
        )

    def _resolve(self, queries: List[AggQuery], idxs: List[int],
                 results: List, counts: Dict[int, int],
                 top: bool = True) -> None:
        """Fill ``results[i]`` for every ``i`` in ``idxs``: on failure retry
        the SAME slice with bounded exponential backoff first, then bisect
        to isolate the poison query, and give a terminal failure a typed
        ``FailedAnswer``, never an exception.

        Bisected sub-slices skip the multi-query retry (the top level spent
        the transient hypothesis); single queries always retry. ``counts``
        tracks ACTUAL executions per query index, which is what
        ``FailedAnswer.attempts`` reports. Re-running a slice can re-record
        some raw answers; a synopsis keeps the better of duplicate answers,
        so isolation never corrupts learned state.
        """
        def run():
            for i in idxs:
                counts[i] = counts.get(i, 0) + 1
            return self._execute_slice([queries[i] for i in idxs])

        try:
            out = run()
        except BaseException as e:  # noqa: BLE001 — isolate, then type it
            out = None
            retries = self.max_retries if (top or len(idxs) == 1) else 0
            for attempt in range(retries):
                time.sleep(min(self.backoff_base_s * 2 ** attempt,
                               self.backoff_max_s))
                try:
                    out = run()
                    break
                except BaseException as retry_e:  # noqa: BLE001
                    e = retry_e
            if out is None:
                if len(idxs) > 1:
                    mid = len(idxs) // 2
                    self._resolve(queries, idxs[:mid], results, counts,
                                  top=False)
                    self._resolve(queries, idxs[mid:], results, counts,
                                  top=False)
                else:
                    results[idxs[0]] = FailedAnswer(
                        error=repr(e), error_type=type(e).__name__,
                        attempts=counts[idxs[0]])
                return
        for i, r in zip(idxs, out):
            results[i] = r

    def flush(self) -> List:
        """Execute all pending queries in one fused scan.

        Every ticket resolves exactly once: to its (possibly wrapped)
        answer, or to a typed ``FailedAnswer`` if its query keeps failing
        after retries and bisection. Concurrent flushes serialize on the
        engine lock; the queue swap is atomic, so two racing flushes split
        the pending work instead of executing it twice.
        """
        return self._flush("flush")

    def _flush(self, caller: str) -> List:
        """``flush``; ``caller`` labels the span of its wait for the engine
        lock (``result``, ``submit``, ``execute`` or ``flush``)."""
        with tracing.span("service.lock_wait", caller=caller):
            self._exec_lock.acquire()
        try:
            with self._lock:
                batch, self._queue = self._queue, []
            if not batch:
                tracing.count("service.empty_flush")
                return []
            requests = (tuple(t._request for _, t in batch)
                        if tracing.enabled() else None)
            with tracing.span("service.flush", request=requests,
                              queries=len(batch)):
                return self._run_batch(batch)
        finally:
            self._exec_lock.release()

    def _run_batch(self, batch: List[tuple]) -> List:
        """Run one swapped-out queue under the engine lock and resolve its
        tickets."""
        start = tracing.stamp()
        for _, ticket in batch:
            tracing.record("service.queued", ticket._submitted, start,
                           request=ticket._request)
        queries = [q for q, _ in batch]
        results: List = [None] * len(batch)
        counts: Dict[int, int] = {}
        try:
            self._resolve(queries, list(range(len(batch))), results,
                          counts)
        finally:
            # Backstop: no ticket may hang or carry None, even if the
            # isolation machinery itself raised.
            out = []
            for (_, ticket), res in zip(batch, results):
                if res is None:
                    res = FailedAnswer(
                        error="flush aborted before this query resolved",
                        error_type="RuntimeError", attempts=0)
                elif (self.result_wrapper is not None
                      and not isinstance(res, FailedAnswer)):
                    res = self.result_wrapper(res)
                ticket._resolve(res)
                out.append(res)
            self.last_stats = self.executor.stats
            with self._lock:
                self.flushes += 1
        return out

    def execute(self, queries: List[AggQuery]) -> List:
        """Submit a workload and return its results in order."""
        tickets = [self.submit(q) for q in queries]
        self._flush("execute")
        return [t.result() for t in tickets]

    def drain(self):
        """Barrier over the engine's async synopsis ingest (snapshot,
        refit and shutdown boundaries); flushes never wait for learning."""
        self.engine.drain()

    def refit(self, **kw):
        """Offline learning boundary: drain pending ingest, then refit."""
        self.engine.refit(**kw)

    def heal(self, manager=None, step: Optional[int] = None) -> dict:
        """Heal quarantined synopses (optionally from a checkpoint's last
        good state) and rejoin them to serving; ``{state_key: healed}``."""
        return self.engine.heal(manager, step)

    def snapshot(self, manager, step: int):
        """Checkpoint the learned state (drains first); a snapshot of a
        sharded service restores into a local one and onto another mesh."""
        self.engine.save_synopses(manager, step)

    def stats(self) -> dict:
        """Operator snapshot: the store's placement, occupancy and
        back-pressure, this service's microbatching counters and its
        serving health."""
        intel = getattr(self.engine, "intel", None)
        return {
            "store": self.engine.store.stats(),
            "tenant": self.tenant,
            "flushes": self.flushes,
            "pending": self.pending,
            "prescreened": self.prescreened,
            "health": {
                "quarantined": self.engine.store.quarantined(),
                "faults": faults.stats(),
            },
            "intel": (intel.stats() if intel is not None
                      else {"enabled": False}),
        }
