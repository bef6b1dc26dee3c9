"""The public Session facade: connect → query → explain/stream/execute.

A driver-level API over the engine/plan core: ``connect`` binds a relation
(plus an ``EngineConfig``, plus optionally a ``Mesh``) to a ``Session``;
queries are built with the typed ``QueryBuilder``; per-call accuracy and
latency contracts are ``ErrorBudget``s; ``explain`` reports the plan the
engine would run (support verdict, snippet counts, dedup, predicted shape
buckets, synopsis and scan placement); ``stream`` yields per-batch refined
answers; answers are typed ``QueryAnswer``/``Cell`` dataclasses. Everything
routes through the same ``repro_torch.aqp.plan`` lifecycle the engine uses,
so facade answers are the engine's.

The session runs on the relation's device (build the relation with
``device="cpu"`` for a CPU session). One ``mesh`` shards both planes: the
scan (a ``ShardedScanPlacement``: any relation over any mesh, answers
bitwise those of the local session) and the learned state (a
``ShardedSynopsisStore``). The mesh's first device must be the relation's:
that is where masks are gathered and answers assembled.
``Session.stats()`` surfaces the scan placement, shard occupancy and
ingest back-pressure. ``connect(cache=...)`` attaches the
workload-intelligence plane (``repro_torch.intel``): an answer cache served
before the scan, a learned serve-path router, and their counters.
``refit`` relearns the GP parameters offline; ``save`` / ``load``
checkpoint the learned synopses (and the intel plane's state) through a
``CheckpointManager``, and ``heal(manager)`` restores quarantined keys from
one. ``serve`` opens a microbatching ``AqpService``
(``repro_torch.serving``) over the session's engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Sequence, Union

from repro_torch.aqp import queries as Q
from repro_torch.aqp.batch import BatchExecutor, BatchStats
from repro_torch.aqp.executor import Mesh, scan_placement
from repro_torch.aqp.plan import (
    PhysicalPlan,
    plain_eval,
    plan_workload,
    replay_rounds,
)
from repro_torch.aqp.relation import Relation
from repro_torch.core.engine import EngineConfig, VerdictEngine
from repro_torch.core.store import (
    ShardedSynopsisStore,
    SynopsisStore,
    group_rows,
    state_key,
)
from repro_torch.core.types import bucket_size
from repro_torch.ft import faults
from repro_torch.intel import IntelConfig, WorkloadIntel
from repro_torch.verdict.answer import PlanReport, QueryAnswer
from repro_torch.verdict.query import QueryBuilder

QueryLike = Union[Q.AggQuery, QueryBuilder]


@dataclasses.dataclass(frozen=True)
class ErrorBudget:
    """Per-call accuracy/latency contract.

    target_rel_error: stop as soon as every cell's relative error bound (at
        confidence ``delta``) is below this; None scans the full budget.
    max_batches: hard cap on sample batches (None: the engine's budget).
    delta: confidence level of the stopping bound (None: the engine's
        ``report_delta``).
    deadline_s: per-query wall-clock bound (None: unbounded). On expiry the
        best-so-far answer returns with its honest (wider) CI, flagged
        ``degraded`` with a ``"deadline"`` reason. At least one sample batch
        always runs.
    """

    target_rel_error: Optional[float] = None
    max_batches: Optional[int] = None
    delta: Optional[float] = None
    deadline_s: Optional[float] = None


def connect(relation: Relation,
            config: Optional[EngineConfig] = None,
            mesh: Optional[Mesh] = None, cache=None,
            tenant: Optional[str] = None) -> "Session":
    """Open a Session over a relation (the driver-level entry point).

    ``mesh``: optional ``Mesh`` whose first device is the relation's. The
    fused scan then runs through a ``ShardedScanPlacement`` over its
    devices, and the learned state is placed per aggregate key by a
    ``ShardedSynopsisStore`` over the same devices. Without a mesh both stay
    on the relation's device.

    ``cache``: opt-in workload intelligence (``repro_torch.intel``) — the
    answer cache + learned serve-path router. ``True`` attaches a default
    ``WorkloadIntel``; an ``IntelConfig`` or a pre-built ``WorkloadIntel``
    customizes it; ``None``/``False`` (default) keeps every path bit for bit
    the engine without one.

    ``tenant``: optional label, surfaced in ``stats()`` and counted in the
    workload-intel per-tenant counters.
    """
    return Session(relation, config, mesh=mesh, cache=cache, tenant=tenant)


class Session:
    """One connection's worth of query/learn state over a relation.

    Wraps a ``VerdictEngine`` plus a persistent ``BatchExecutor`` so
    workload-level fusion stats survive across calls (``last_stats``).
    """

    def __init__(self, relation: Relation,
                 config: Optional[EngineConfig] = None,
                 mesh: Optional[Mesh] = None, cache=None,
                 tenant: Optional[str] = None, _engine=None):
        self.tenant = tenant
        if _engine is not None:
            # Attach mode (Session.attached): wrap an EXISTING engine —
            # shared store and intel plane, own executor stats and tenant
            # label.
            self.engine = _engine
            self._executor = BatchExecutor(self.engine)
            return
        store = None
        if mesh is not None:
            if mesh.devices[0] != relation.device:
                raise ValueError(
                    f"the mesh's first device is {mesh.devices[0]} but the "
                    f"relation lives on {relation.device}; the session runs "
                    "on the relation's device")
            store = (lambda schema, cfg:
                     ShardedSynopsisStore(schema, cfg, mesh=mesh))
        intel = None
        if cache:  # True | IntelConfig | WorkloadIntel (None/False: off)
            if isinstance(cache, WorkloadIntel):
                intel = cache
            elif isinstance(cache, IntelConfig):
                intel = WorkloadIntel(cache)
            else:
                intel = WorkloadIntel()
        self.engine = VerdictEngine(relation, config, device=relation.device,
                                    store=store, scan=scan_placement(mesh),
                                    intel=intel)
        # The executor scans through the engine's ScanPlacement, so
        # execute, execute_many and stream all go through the same seam.
        self._executor = BatchExecutor(self.engine)

    @classmethod
    def attached(cls, engine, tenant: Optional[str] = None) -> "Session":
        """A Session over an EXISTING engine (or another Session's engine):
        it reads and writes the same learned state while keeping its own
        workload stats and tenant label. The caller serializes engine
        access across attached sessions."""
        return cls(None, _engine=getattr(engine, "engine", engine),
                   tenant=tenant)

    # ------------------------------------------------------------ properties
    @property
    def schema(self):
        return self.engine.schema

    @property
    def config(self) -> EngineConfig:
        return self.engine.config

    @property
    def store(self) -> SynopsisStore:
        """The session's synopsis store (placement-aware learned state)."""
        return self.engine.store

    @property
    def last_stats(self) -> BatchStats:
        """Fusion accounting of the most recent execute/execute_many call."""
        return self._executor.stats

    @property
    def intel(self) -> Optional[WorkloadIntel]:
        """The workload-intelligence plane (``connect(cache=...)``), or
        None when the session runs without one."""
        return self.engine.intel

    # --------------------------------------------------------------- queries
    def query(self) -> QueryBuilder:
        """Start a typed query: ``session.query().avg("v0").where(...)``."""
        return QueryBuilder(self.engine.schema)

    @staticmethod
    def _lower(q: QueryLike) -> Q.AggQuery:
        return q.build() if isinstance(q, QueryBuilder) else q

    # --------------------------------------------------------------- execute
    def execute(self, q: QueryLike,
                budget: Optional[ErrorBudget] = None) -> QueryAnswer:
        return self.execute_many([q], budget=budget)[0]

    def execute_many(self, queries: Sequence[QueryLike],
                     budget: Optional[ErrorBudget] = None
                     ) -> List[QueryAnswer]:
        """Answer a workload in one fused scan (see ``repro_torch.aqp.batch``)."""
        budget = budget or ErrorBudget()
        results = self._executor.execute_many(
            [self._lower(q) for q in queries],
            target_rel_error=budget.target_rel_error,
            max_batches=budget.max_batches,
            stop_delta=budget.delta,
            deadline_s=budget.deadline_s,
            tenant=self.tenant,
        )
        return [QueryAnswer.from_result(r) for r in results]

    # --------------------------------------------------------------- explain
    def explain(self, q: QueryLike,
                budget: Optional[ErrorBudget] = None) -> PlanReport:
        """Plan a query without scanning past the group-discovery probe.

        Reports, per aggregate-function key, the predicted serve tiles and
        the store's shard assignment — for keys that do not exist yet, where
        the state *would* be placed (a pure function of the key). With
        workload intelligence attached (``connect(cache=...)``), also
        reports the answer-cache status (exact/subsumed/miss/uncacheable)
        and the route the serve router would pick under ``budget`` —
        read-only: explaining never moves LRU state, counters or probe
        streaks.
        """
        eng = self.engine
        budget = budget or ErrorBudget()
        scan = eng.scan.describe()
        evaluator = eng.scan.evaluator_for(eng._eval_fn, eng.device)
        wp = plan_workload(eng, [self._lower(q)])
        lp = wp.logical[0]
        cache_status, route = None, None
        if eng.intel is not None:
            cache_status, route = eng.intel.peek(
                eng, self._lower(q),
                target_rel_error=budget.target_rel_error,
                stop_delta=budget.delta,
                max_batches=budget.max_batches, lp=lp)
        if lp.plan is None:
            return PlanReport(True, None, 0, 0, 0, 0, 0, 1.0, {}, {}, {},
                              scan_placement=scan, scan_evaluator=evaluator,
                              cache=cache_status, route=route)
        q_buckets, fill_buckets, placement, quarantined = {}, {}, {}, {}
        for key, rows in group_rows(lp.plan.snippets):
            q_buckets[key] = bucket_size(len(rows), eng.config.min_q_bucket)
            syn = eng.store.get(key)
            fill_buckets[key] = syn._fill_bucket() if syn is not None else 0
            placement[key] = eng.store.describe_placement(key)
            if syn is not None and syn.quarantined:
                quarantined[state_key(key)] = syn.quarantine_reason
        return PlanReport(
            supported=lp.supported,
            unsupported_reason=lp.reason,
            n_cells=len(lp.plan.cells),
            n_groups=len(lp.plan.groups),
            truncated_groups=lp.truncated_groups,
            n_snippets=lp.plan.snippets.n,
            n_snippets_unique=wp.stats.n_snippets_fused,
            dedup_ratio=wp.stats.dedup_ratio,
            q_buckets=q_buckets,
            fill_buckets=fill_buckets,
            placement=placement,
            scan_placement=scan,
            scan_evaluator=evaluator,
            quarantined=quarantined,
            cache=cache_status,
            route=route,
        )

    # ---------------------------------------------------------------- stream
    def stream(self, q: QueryLike,
               budget: Optional[ErrorBudget] = None
               ) -> Iterator[QueryAnswer]:
        """Online aggregation: yield a refined answer after every batch.

        Each yielded ``QueryAnswer`` carries the improved (validated)
        estimates after batches ``0..b``; the last one (``final=True``) is
        what ``execute`` under the same budget returns, and only its raw
        answers are recorded into the synopsis. This is ``replay_rounds``,
        the generator ``execute`` consumes, surfaced round by round. A cache
        hit collapses the stream to its one final answer.
        """
        eng = self.engine
        budget = budget or ErrorBudget()
        if eng.intel is not None:
            served = eng.intel.lookup(
                eng, self._lower(q),
                target_rel_error=budget.target_rel_error,
                stop_delta=budget.delta, max_batches=budget.max_batches,
                tenant=self.tenant)
            if served is not None:
                # What execute() under the same budget returns.
                yield QueryAnswer.from_result(served, final=True)
                return
        wp = plan_workload(eng, [self._lower(q)])
        lp = wp.logical[0]
        phys = PhysicalPlan(
            eng.batches,
            wp.fused if lp.supported else wp.fused_raw,
            self._executor._eval if lp.supported else plain_eval,
        )
        deadline = (None if budget.deadline_s is None
                    else time.monotonic() + float(budget.deadline_s))
        for res, final in replay_rounds(
            eng, lp, phys,
            target_rel_error=budget.target_rel_error,
            max_batches=budget.max_batches,
            stop_delta=budget.delta,
            every_batch=True,
            deadline=deadline,
        ):
            yield QueryAnswer.from_result(res, final=final)

    # ------------------------------------------------------------- lifecycle
    def refit(self, **kw):
        """Offline learning pass (Algorithm 1); drains async ingest.
        Keywords: ``steps``, ``lr``, ``learn_sigma``."""
        self.engine.refit(**kw)

    def drain(self):
        """Barrier over async synopsis ingest (snapshot boundaries)."""
        self.engine.drain()

    def ingest_stats(self) -> dict:
        """Per-synopsis async-ingest back-pressure telemetry."""
        return self.engine.ingest_stats()

    def stats(self) -> dict:
        """Operator snapshot of the learned-state and scan planes.

        ``store``: placement kind, per-key occupancy/placement/ingest
        telemetry, and (sharded) per-shard occupancy. ``scan``: the scan
        plane's placement and its true scanned-tuple accounting
        (``tuples_scanned`` counts valid tuples only; ``pad_rows`` is the
        padding the mesh needed). ``workload``: fusion accounting of the
        most recent execute/execute_many call. ``health``: quarantined
        synopses (``{state_key: reason}``) and the active fault plan's
        counters. ``intel``: the workload-intelligence plane's
        hit/miss/subsumption/staleness/route counters (``{"enabled": False}``
        without one). ``tenant``: this session's label.
        """
        return {
            "tenant": self.tenant,
            "store": self.engine.store.stats(),
            "scan": self.engine.scan.stats(),
            "workload": dataclasses.asdict(self.last_stats),
            "health": {
                "quarantined": self.engine.store.quarantined(),
                "faults": faults.stats(),
            },
            "intel": (self.engine.intel.stats()
                      if self.engine.intel is not None
                      else {"enabled": False}),
        }

    def heal(self, manager=None, step: Optional[int] = None) -> dict:
        """Heal every quarantined synopsis and rejoin it to serving.

        With a ``CheckpointManager``, keys restore from the last good
        committed checkpoint and replay their parked ingest batches; without
        one they rebuild from their own row arrays. Returns
        ``{state_key: healed}`` for the keys that were quarantined.
        """
        return self.engine.heal(manager, step)

    def save(self, manager, step: int):
        """Checkpoint the learned synopses through a CheckpointManager."""
        self.engine.save_synopses(manager, step)

    def load(self, manager, step: Optional[int] = None):
        """Restore learned synopses; the session resumes smarter. Returns
        the checkpoint's ``extra``."""
        return self.engine.load_synopses(manager, step)

    def serve(self, max_batch: int = 64,
              budget: Optional[ErrorBudget] = None, engine_lock=None):
        """A microbatching ``AqpService`` over this session's engine.

        The full ``budget`` (target, max_batches, delta, deadline_s)
        applies to every flush, builders are accepted, and tickets resolve
        to the typed ``QueryAnswer`` the session's own execute returns. The
        session's tenant label rides along; ``engine_lock`` serializes
        services that share this engine. No mesh is passed: the service's
        executor adopts ``engine.scan``, so served queries keep the
        session's (possibly sharded) scan and count in
        ``stats()["scan"]``.
        """
        from repro_torch.serving.aqp import AqpService

        budget = budget or ErrorBudget()
        return AqpService(self.engine, max_batch=max_batch,
                          target_rel_error=budget.target_rel_error,
                          max_batches=budget.max_batches,
                          stop_delta=budget.delta,
                          deadline_s=budget.deadline_s,
                          result_wrapper=QueryAnswer.from_result,
                          tenant=self.tenant, engine_lock=engine_lock)
