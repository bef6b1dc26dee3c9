"""Unified query-plan IR: ONE lifecycle shared by every execution path.

The paper's Figure 2 pipeline — decompose, scan, improve, validate, learn —
split into a logical and a physical layer:

- ``LogicalPlan``: per-query planning output — the support verdict (§2.2),
  the probe actually evaluated (raw-only queries scan their supported
  subset), the ``SnippetPlan`` decomposition (§2.3), and the query's row ids
  into the workload's *fused* snippet set (cross-query dedup by content
  hash, ``snippet_key``).
- ``plan_workload``: queries → ``WorkloadPlan`` (logical plans + the two
  fused snippet sets + fusion accounting). Group-by values for the whole
  workload are discovered with ONE first-batch probe.
- ``PhysicalPlan``: a tile-padded fused snippet set, placed on the engine's
  device and bound to a sample-batch stream, scanned lazily with cumulative
  partials snapshots — each sample batch is evaluated at most once no matter
  how many queries replay over it.
- ``replay_query``: the improve → validate → early-stop → record lifecycle
  for one logical plan against a physical plan. ``VerdictEngine.execute``
  and ``BatchExecutor`` both call this one function, so
  ``execute(q) == execute_many([q])[0]`` by construction.

Planning metadata (snippet sets, row ids) lives on the host; scans and
partials live on the engine's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.aqp import queries as Q
from repro_torch.aqp.executor import Partials, estimates_from_partials
from repro_torch.aqp.sampler import SampleBatches
from repro_torch.core.types import (
    ImprovedAnswer,
    RawAnswer,
    SnippetBatch,
    pad_snippets,
    snippet_key,
)
from repro_torch.kernels.fused_masked_scan.ops import eval_partials_fused
from repro_torch.utils import tracing
from repro_torch.utils.stats import confidence_multiplier


@dataclasses.dataclass
class QueryResult:
    """Engine-level answer for one query (dict cells).

    ``truncated_groups``: group-by cells dropped by the ``n_max`` cap in
    ``Q.decompose``. ``degraded``/``degraded_reasons``: a quarantined
    synopsis left its groups on the raw sample estimate (``{state_key:
    reason}``), or a deadline returned the best-so-far answer
    (``"deadline"``). Either way the (estimate, CI) pair is valid.

    ``served_from``: None for executed answers; ``"cache:exact"`` /
    ``"cache:subsumed"`` when the workload-intelligence plane
    (``repro_torch.intel``) served this answer from its answer cache without
    scanning.
    """

    cells: List[dict]
    batches_used: int
    tuples_scanned: int
    supported: bool
    unsupported_reason: Optional[str] = None
    snippet_answer: Optional[ImprovedAnswer] = None
    plan: Optional[Q.SnippetPlan] = None
    truncated_groups: int = 0
    degraded: bool = False
    degraded_reasons: Dict[str, str] = dataclasses.field(default_factory=dict)
    served_from: Optional[str] = None

    def max_rel_error(self, delta: float = 0.95) -> float:
        alpha = float(confidence_multiplier(delta))
        worst = 0.0
        for c in self.cells:
            denom = max(abs(c["estimate"]), 1e-9)
            worst = max(worst, alpha * np.sqrt(c["beta2"]) / denom)
        return worst


@dataclasses.dataclass
class BatchStats:
    """Fusion accounting for one planned workload."""

    n_queries: int = 0
    n_snippets_total: int = 0  # sum of per-query plan sizes
    n_snippets_fused: int = 0  # after cross-query dedup
    eval_calls: int = 0  # one per (fused set, scanned sample batch)
    batches_scanned: int = 0
    tuples_scanned: int = 0  # TRUE tuples evaluated (never counts padding)

    @property
    def dedup_ratio(self) -> float:
        return self.n_snippets_total / max(self.n_snippets_fused, 1)


@dataclasses.dataclass
class LogicalPlan:
    """Planning output for one query within a workload.

    ``plan is None`` ⇔ the query is supported but its group-by probe found
    no groups (empty result set, nothing to scan). ``rows`` are this query's
    snippet row ids into the workload's fused set (supported queries index
    the main set, raw-only probes the plain-eval set).
    """

    index: int
    query: Q.AggQuery
    probe: Q.AggQuery
    reason: Optional[str]
    plan: Optional[Q.SnippetPlan]
    rows: Optional[np.ndarray]

    @property
    def supported(self) -> bool:
        return self.reason is None

    @property
    def truncated_groups(self) -> int:
        return self.plan.truncated_groups if self.plan is not None else 0


class SnippetInterner:
    """Accumulates unique snippets across plans, hash-keyed like Synopsis."""

    def __init__(self, schema):
        self.schema = schema
        self._keys: Dict[int, int] = {}
        self.lo: List[np.ndarray] = []
        self.hi: List[np.ndarray] = []
        self.cat: List[np.ndarray] = []
        self.agg: List[int] = []
        self.measure: List[int] = []

    def intern(self, snippets: SnippetBatch) -> np.ndarray:
        lo, hi, cat, agg, mea = snippets.numpy()
        rows = np.empty((lo.shape[0],), np.int64)
        for i in range(lo.shape[0]):
            key = snippet_key(lo[i], hi[i], cat[i], agg[i], mea[i])
            r = self._keys.get(key)
            if r is None:
                r = len(self.agg)
                self._keys[key] = r
                self.lo.append(lo[i])
                self.hi.append(hi[i])
                self.cat.append(cat[i])
                self.agg.append(int(agg[i]))
                self.measure.append(int(mea[i]))
            rows[i] = r
        return rows

    @property
    def n(self) -> int:
        return len(self.agg)

    def fused(self) -> SnippetBatch:
        if not self.agg:  # all interned plans were empty
            return SnippetBatch.empty(self.schema)
        return SnippetBatch.from_numpy(
            np.stack(self.lo), np.stack(self.hi), np.stack(self.cat),
            np.asarray(self.agg, np.int32), np.asarray(self.measure, np.int32),
            "cpu")


@dataclasses.dataclass
class WorkloadPlan:
    """Logical plans for a workload plus its two fused snippet sets
    (supported queries; raw-only probes)."""

    logical: List[LogicalPlan]
    fused: SnippetBatch
    fused_raw: SnippetBatch
    stats: BatchStats


def plan_workload(engine, queries: Sequence[Q.AggQuery]) -> WorkloadPlan:
    """Plan + dedup a whole workload (one fused group-discovery probe)."""
    cfg = engine.config
    stats = BatchStats(n_queries=len(queries))
    intern_main = SnippetInterner(engine.schema)
    intern_raw = SnippetInterner(engine.schema)
    logical: List[LogicalPlan] = []
    reasons = [Q.unsupported_reason(q) for q in queries]
    probes = [q if r is None else engine.raw_only_probe(q)
              for q, r in zip(queries, reasons)]
    groups_all = engine._discover_groups_many(probes)
    for qi, q in enumerate(queries):
        reason, probe, groups = reasons[qi], probes[qi], groups_all[qi]
        if reason is None and not groups:
            logical.append(LogicalPlan(qi, q, probe, reason, None, None))
            continue
        plan = Q.decompose(engine.schema, probe, groups, n_max=cfg.n_max)
        interner = intern_main if reason is None else intern_raw
        rows = interner.intern(plan.snippets)
        stats.n_snippets_total += plan.snippets.n
        logical.append(LogicalPlan(qi, q, probe, reason, plan, rows))
    stats.n_snippets_fused = intern_main.n + intern_raw.n
    return WorkloadPlan(
        logical=logical,
        fused=intern_main.fused(),
        fused_raw=intern_raw.fused(),
        stats=stats,
    )


class PhysicalPlan:
    """A padded fused snippet set + the lazy cumulative-partials scan.

    ``eval_fn(block, padded) -> Partials`` is the per-batch evaluator —
    ``BatchExecutor._eval`` (the engine's ``ScanPlacement``, local or
    sharded), or ``plain_eval`` for raw-only probes.
    The padded set is placed on the sample's device once. Sample batches are
    pulled on demand; snapshot ``b`` holds the cumulative partials of
    batches ``0..b``, and per-batch estimates are cached.
    """

    def __init__(
        self,
        batches: SampleBatches,
        snippets: SnippetBatch,
        eval_fn: Callable[[object, SnippetBatch], Partials],
        stats: Optional[BatchStats] = None,
    ):
        self.batches = batches
        self.n = snippets.n
        self.padded = pad_snippets(snippets).to(batches.relation.device)
        self.eval_fn = eval_fn
        self.stats = stats
        self._snapshots: List[Partials] = []
        self._estimates: Dict[int, Tuple] = {}

    def partials_at(self, b: int) -> Partials:
        """Cumulative partials of batches ``0..b``, sliced to the
        non-padding snippets (scans lazily like ``raw_at``)."""
        self.raw_at(b)
        p = self._snapshots[b]
        return Partials(p.sums[: self.n], p.sumsq[: self.n],
                        p.count[: self.n], p.scanned)

    def raw_at(self, b: int, rows: Optional[np.ndarray] = None) -> RawAnswer:
        """Raw answers after batches ``0..b`` for ``rows`` of the fused set
        (``None``: every non-padding snippet, in interning order)."""
        while len(self._snapshots) <= b:
            i = len(self._snapshots)
            block = self.batches.relation.take(self.batches.batch_rows[i])
            with tracing.span("scan.block", snippets=self.padded.n,
                              tuples=block.cardinality):
                part = self.eval_fn(block, self.padded)
            self._snapshots.append(
                part if not self._snapshots else self._snapshots[-1] + part
            )
            if self.stats is not None:
                self.stats.eval_calls += 1
                self.stats.batches_scanned += 1
                self.stats.tuples_scanned += len(self.batches.batch_rows[i])
        with tracing.span("replay.estimate"):
            if b not in self._estimates:
                theta, beta2, _ = estimates_from_partials(
                    self._snapshots[b], self.padded
                )
                self._estimates[b] = (theta, beta2)
            theta, beta2 = self._estimates[b]
            if rows is None:
                return RawAnswer(theta[: self.n], beta2[: self.n])
            idx = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=theta.device)
            return RawAnswer(theta[idx], beta2[idx])


def plain_eval(block, padded: SnippetBatch) -> Partials:
    """The evaluator raw-only probes scan through: the same scan wrapper as
    supported queries, so on the card it launches the kernel too."""
    return eval_partials_fused(
        block.num_normalized, block.cat, block.measures, padded
    )


def replay_rounds(
    engine,
    lp: LogicalPlan,
    physical: PhysicalPlan,
    target_rel_error: Optional[float] = None,
    max_batches: Optional[int] = None,
    stop_delta: Optional[float] = None,
    every_batch: bool = False,
    deadline: Optional[float] = None,
):
    """The single query lifecycle, one round per evaluated sample batch.

    Yields ``(QueryResult, final)`` pairs: improve via the synopsis,
    validate, check the early-stop target (at confidence ``stop_delta``,
    default the engine's ``report_delta``), and — only on the final round —
    record the raw answers for learning. ``replay_query`` consumes this for
    one-shot execution; ``Session.stream`` surfaces every round.

    ``every_batch=False`` evaluates only the rounds the one-shot result
    needs (all of them under a target or a deadline, just the last one
    otherwise); ``every_batch=True`` evaluates and yields after every sample
    batch. Raw-only (unsupported) queries never early-stop and never record.

    ``deadline``: absolute ``time.monotonic()`` budget, checked AFTER each
    round: on expiry the round just computed becomes final, flagged
    ``degraded`` with a ``"deadline"`` reason. At least one round runs.
    """
    cfg = engine.config
    max_batches = min(
        max_batches or engine.batches.n_batches, engine.batches.n_batches
    )
    stop_delta = cfg.report_delta if stop_delta is None else float(stop_delta)
    if lp.plan is None:  # supported, but no group-by values discovered
        yield QueryResult([], 0, 0, True, plan=None), True
        return
    card = engine.batches.source_cardinality
    # Serve-path routing (repro_torch.intel): under a target the router may
    # pick "scan" — skip the per-round improve/validate checks and evaluate
    # the full budget in one final round — when the learned E[batches] says
    # the improve path was not going to stop early anyway. Without an intel
    # plane the route is always "improve" under a target.
    intel = getattr(engine, "intel", None)
    route = "scan"
    if target_rel_error is not None:
        route = "improve"
        if (intel is not None and lp.supported and not every_batch
                and deadline is None):
            route = intel.choose_route(engine, lp, target_rel_error,
                                       max_batches)
    all_rounds = (every_batch or deadline is not None
                  or (target_rel_error is not None and route == "improve"))
    if not lp.supported:
        # Raw AQP answers over the full budget, no learning (paper §2.2).
        rounds = (range(max_batches) if every_batch or deadline is not None
                  else (max_batches - 1,))
        for b in rounds:
            raw = physical.raw_at(b, lp.rows)
            with tracing.span("replay.assemble"):
                cells = Q.assemble_results(lp.plan, raw.theta, raw.beta2,
                                           card)
            used = b + 1
            res = QueryResult(
                cells, used, engine._tuples(used), False, lp.reason,
                plan=lp.plan, truncated_groups=lp.truncated_groups,
            )
            expired = deadline is not None and time.monotonic() >= deadline
            final = expired or b == max_batches - 1
            if expired and b < max_batches - 1:
                res.degraded = True
                res.degraded_reasons["deadline"] = (
                    f"deadline expired after {used} of {max_batches} batches"
                )
            yield res, final
            if final:
                return
        return
    n = lp.plan.snippets.n
    rounds = range(max_batches) if all_rounds else (max_batches - 1,)
    for b in rounds:
        raw = physical.raw_at(b, lp.rows)
        used = b + 1
        health: Dict[str, str] = {}
        if cfg.learning:
            with tracing.span("replay.improve"):
                improved = engine.store.improve_groups(
                    lp.plan.snippets, raw, use_kernels=cfg.use_kernels,
                    health=health)
        else:
            improved = ImprovedAnswer(
                raw.theta, raw.beta2, raw.theta, raw.beta2,
                torch.zeros((n,), dtype=torch.bool, device=raw.theta.device),
            )
        with tracing.span("replay.assemble"):
            cells = Q.assemble_results(lp.plan, improved.theta,
                                       improved.beta2, card)
        res = QueryResult(
            cells, used, engine._tuples(used), True,
            snippet_answer=improved, plan=lp.plan,
            truncated_groups=lp.truncated_groups,
            degraded=bool(health), degraded_reasons=health,
        )
        met = (target_rel_error is not None
               and res.max_rel_error(stop_delta) <= target_rel_error)
        expired = deadline is not None and time.monotonic() >= deadline
        final = met or expired or b == max_batches - 1
        if expired and not met and b < max_batches - 1:
            res.degraded = True
            res.degraded_reasons["deadline"] = (
                f"deadline expired after {used} of {max_batches} batches"
            )
        if final:
            if cfg.learning:
                with tracing.span("replay.record"):
                    engine.store.record(lp.plan.snippets, raw)
            if intel is not None:
                # After record: Synopsis.add bumps its generation at enqueue
                # time, so the cached entry's generation snapshot includes
                # this answer's own ingest — an exact repeat is fresh.
                intel.observe(engine, lp, res, target_rel_error,
                              max_batches, route)
        yield res, final
        if final:
            return


def replay_query(
    engine,
    lp: LogicalPlan,
    physical: PhysicalPlan,
    target_rel_error: Optional[float] = None,
    max_batches: Optional[int] = None,
    stop_delta: Optional[float] = None,
    deadline: Optional[float] = None,
) -> QueryResult:
    """One-shot lifecycle: the final round of ``replay_rounds``, inside
    the query's ``replay.query`` span."""
    result = None
    with tracing.span("replay.query", request=id(lp.query)):
        for result, _ in replay_rounds(
            engine, lp, physical, target_rel_error=target_rel_error,
            max_batches=max_batches, stop_delta=stop_delta,
            deadline=deadline,
        ):
            pass
    return result
