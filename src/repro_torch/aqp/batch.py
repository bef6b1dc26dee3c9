"""Batched multi-query execution with cross-query snippet dedup.

Every query's snippets in a workload overlap (repeated dashboards, shared
group-by cells, popular predicate columns), so ``BatchExecutor`` fuses a
whole workload into one scan. The machinery lives in the shared plan IR
(``repro_torch.aqp.plan``):

1. ``plan_workload`` decomposes every query into its ``LogicalPlan`` and
   dedups identical snippets across queries into two fused sets;
2. two ``PhysicalPlan``s scan sample batches lazily, evaluating each batch
   EXACTLY ONCE for the union of snippets — supported queries through the
   executor's ``ScanPlacement`` (the engine's own by default, or sharded
   over a ``mesh=``) with the engine's per-block evaluator, raw-only probes
   through ``plain_eval``; on the card both launch a scan kernel;
3. ``replay_query`` replays queries in submission order against cumulative
   per-batch partials: improve, early-stop per query, record — the same
   state transitions, in the same order, as query-at-a-time execution.

With a workload-intelligence plane attached (``engine.intel``), queries the
answer cache serves drop out before step 1.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

from repro_torch.aqp import queries as Q
from repro_torch.aqp.executor import ScanPlacement, scan_placement
from repro_torch.aqp.plan import (
    BatchStats,
    PhysicalPlan,
    QueryResult,
    plain_eval,
    plan_workload,
    replay_query,
)
from repro_torch.core.types import SnippetBatch
from repro_torch.utils import tracing

__all__ = ["BatchExecutor", "BatchStats"]


class BatchExecutor:
    """Fused executor over one ``VerdictEngine`` (see module docstring).

    The scan routes through a ``ScanPlacement`` with the engine's per-block
    evaluator: pass ``placement=`` directly, or ``mesh=`` (a
    ``repro_torch.aqp.executor.Mesh`` with an axis ``mesh_axis``, which the
    scan is split over) to build a ``ShardedScanPlacement``; with neither, the
    engine's own placement (``engine.scan``), so served queries accrue
    into the engine's scan telemetry. Stats of the latest call are kept in
    ``self.stats``.
    """

    def __init__(self, engine, mesh=None, mesh_axis: str = "data",
                 placement: Optional[ScanPlacement] = None):
        self.engine = engine
        if placement is None:
            if mesh is not None and mesh_axis not in mesh.axis_names:
                raise ValueError(f"mesh_axis {mesh_axis!r} is not an axis of "
                                 f"the mesh {mesh.axis_names}")
            placement = (scan_placement(mesh, mesh_axis) if mesh is not None
                         else engine.scan)
        self.placement = placement
        self.mesh = placement.mesh
        self.mesh_axis = placement.axis
        self.stats = BatchStats()

    def _eval(self, block, padded: SnippetBatch):
        return self.placement.eval_block(
            block, padded, local_eval=self.engine._eval_fn)

    def execute_many(
        self,
        queries: Sequence[Q.AggQuery],
        target_rel_error: Optional[float] = None,
        max_batches: Optional[int] = None,
        stop_delta: Optional[float] = None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> List[QueryResult]:
        """``deadline_s``: per-query wall-clock budget, measured from each
        query's replay start. On expiry the best-so-far answer returns,
        ``degraded`` with a ``"deadline"`` reason — every query resolves.
        ``tenant``: optional label counted in the workload-intel plane's
        per-tenant lookup/hit counters."""
        eng = self.engine
        max_batches = min(
            max_batches or eng.batches.n_batches, eng.batches.n_batches
        )
        results: List[Optional[QueryResult]] = [None] * len(queries)
        # Workload-intelligence pre-screen (repro_torch.intel): queries
        # served from the answer cache drop out BEFORE planning — no probe,
        # no scan, no improve, no record, no kernel launch. Misses flow
        # through the unchanged lifecycle: bitwise an engine with the same
        # router and no cache.
        intel = getattr(eng, "intel", None)
        live_idx = list(range(len(queries)))
        if intel is not None:
            live_idx = []
            for i, q in enumerate(queries):
                served = intel.lookup(
                    eng, q, target_rel_error=target_rel_error,
                    stop_delta=stop_delta, max_batches=max_batches,
                    tenant=tenant)
                if served is not None:
                    results[i] = served
                else:
                    live_idx.append(i)
        if not live_idx:  # every query was served from the cache
            self.stats = BatchStats()
            return results
        with tracing.span("plan", queries=len(live_idx)):
            wp = plan_workload(eng, [queries[i] for i in live_idx])
            self.stats = wp.stats
            phys_main = PhysicalPlan(eng.batches, wp.fused, self._eval,
                                     stats=wp.stats)
            phys_raw = PhysicalPlan(eng.batches, wp.fused_raw, plain_eval,
                                    stats=wp.stats)
        for lp in wp.logical:
            deadline = (None if deadline_s is None
                        else time.monotonic() + float(deadline_s))
            results[live_idx[lp.index]] = replay_query(
                eng, lp, phys_main if lp.supported else phys_raw,
                target_rel_error=target_rel_error, max_batches=max_batches,
                stop_delta=stop_delta, deadline=deadline,
            )
        return results
