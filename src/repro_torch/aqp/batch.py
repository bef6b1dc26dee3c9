"""Batched multi-query execution with cross-query snippet dedup.

Every query's snippets in a workload overlap (repeated dashboards, shared
group-by cells, popular predicate columns), so ``BatchExecutor`` fuses a
whole workload into one scan. The machinery lives in the shared plan IR
(``repro_torch.aqp.plan``):

1. ``plan_workload`` decomposes every query into its ``LogicalPlan`` and
   dedups identical snippets across queries into two fused sets;
2. two ``PhysicalPlan``s scan sample batches lazily, evaluating each batch
   EXACTLY ONCE for the union of snippets — on the card through the
   ``fused_masked_scan`` kernel, for supported queries and raw-only probes
   alike;
3. ``replay_query`` replays queries in submission order against cumulative
   per-batch partials: improve, early-stop per query, record — the same
   state transitions, in the same order, as query-at-a-time execution.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

from repro_torch.aqp import queries as Q
from repro_torch.aqp.plan import (
    BatchStats,
    PhysicalPlan,
    QueryResult,
    plain_eval,
    plan_workload,
    replay_query,
)

__all__ = ["BatchExecutor", "BatchStats"]


class BatchExecutor:
    """Fused executor over one ``VerdictEngine`` (see module docstring).

    The scan routes through the engine's ``ScanPlacement``. Stats of the
    latest call are kept in ``self.stats``.
    """

    def __init__(self, engine):
        self.engine = engine
        self.stats = BatchStats()

    def execute_many(
        self,
        queries: Sequence[Q.AggQuery],
        target_rel_error: Optional[float] = None,
        max_batches: Optional[int] = None,
        stop_delta: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> List[QueryResult]:
        """``deadline_s``: per-query wall-clock budget, measured from each
        query's replay start. On expiry the best-so-far answer returns,
        ``degraded`` with a ``"deadline"`` reason — every query resolves."""
        eng = self.engine
        max_batches = min(
            max_batches or eng.batches.n_batches, eng.batches.n_batches
        )
        wp = plan_workload(eng, queries)
        self.stats = wp.stats
        phys_main = PhysicalPlan(eng.batches, wp.fused, eng.scan.eval_block,
                                 stats=wp.stats)
        phys_raw = PhysicalPlan(eng.batches, wp.fused_raw, plain_eval,
                                stats=wp.stats)
        results: List[Optional[QueryResult]] = [None] * len(queries)
        for lp in wp.logical:
            deadline = (None if deadline_s is None
                        else time.monotonic() + float(deadline_s))
            results[lp.index] = replay_query(
                eng, lp, phys_main if lp.supported else phys_raw,
                target_rel_error=target_rel_error, max_batches=max_batches,
                stop_delta=stop_delta, deadline=deadline,
            )
        return results
