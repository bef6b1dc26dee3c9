"""VerdictEngine: the end-to-end DBL query engine (paper Figure 2, Algorithm 2).

Workflow per query:
  1. support check (§2.2) — unsupported queries bypass inference entirely;
  2. decompose into snippets (§2.3), discovering group-by values from the
     first sample batch;
  3. online aggregation over sample batches; after each batch the raw
     answers are improved via the per-aggregate-function synopsis model and
     validated (Appendix B); stop early once the improved error bound meets
     the target;
  4. insert the final raw answers into the synopsis (the model learns from
     *raw* answers, never from its own outputs).

The lifecycle lives in the shared plan IR (``repro_torch.aqp.plan``); ALL
learned state lives behind the store (``repro_torch.core.store``); the scan
routes through a ``ScanPlacement``. ``execute(q)`` is literally
``execute_many([q])[0]``. Pass ``store=`` (an instance or a
``(schema, config) -> SynopsisStore`` factory) and/or ``scan=`` to choose
placement per plane — ``LocalSynopsisStore`` + local ``ScanPlacement`` by
default, ``ShardedSynopsisStore`` + ``ShardedScanPlacement`` over a mesh
(``repro_torch.verdict.connect`` wires both from its ``mesh=`` argument).

Device: the engine runs on ``device`` (``None``: the CUDA card, failing
loudly when there is none). The relation must already live there. On the
card every scan launches a scan kernel (``fused_masked_scan`` locally,
``masked_partials`` under a mesh), every improve the ``gp_batch_infer``
kernel, whatever ``use_kernels`` says, and every covariance build the
SE-covariance kernel (``refit``'s Adam steps its gradient kernel too); on
the CPU the plain versions run.

Lifecycle beyond serving: ``refit`` (offline learning, Appendix A),
``save_synopses`` / ``load_synopses`` through a
``repro_torch.ft.checkpoint.CheckpointManager`` (the reference's format:
either package's checkpoint loads in the other), and ``heal``.

``intel=``: an optional workload-intelligence plane
(``repro_torch.intel.WorkloadIntel``: answer cache, serve-path router,
telemetry), which ``repro_torch.verdict.connect(cache=...)`` attaches. A hit
is served on the host before the scan and launches no kernel; misses run the
lifecycle above unchanged. Its state rides in the checkpoint payload.

``learning=False`` turns the engine into the NoLearn baseline of §8.1.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.aqp import queries as Q
from repro_torch.aqp.executor import (
    ScanPlacement,
    predicate_mask,
)
from repro_torch.aqp.plan import QueryResult
from repro_torch.aqp.relation import Relation
from repro_torch.aqp.sampler import SampleBatches, build_sample
from repro_torch.core.store import LocalSynopsisStore, SynopsisStore, agg_key
from repro_torch.core.synopsis import MIN_FILL_BUCKET, MIN_Q_BUCKET, Synopsis
from repro_torch.core.types import (
    Schema,
    SnippetBatch,
    pad_snippets,
    resolve_device,
    to_numpy,
)
from repro_torch.utils import tracing


@dataclasses.dataclass
class EngineConfig:
    sample_rate: float = 0.1
    n_batches: int = 10
    capacity: int = 2000  # C_g
    n_max: int = 1000  # N^max
    delta_v: float = 0.99
    report_delta: float = 0.95
    learning: bool = True
    seed: int = 0
    # The improve step's precision contract, as in the reference: False →
    # float64 answers (the reference's f64 jnp path); True → the float32
    # improve kernel (the reference kernel's precision; engine-level budget
    # 1e-3). On a CUDA device BOTH settings launch the scan and improve
    # kernels — the plain versions never run there.
    use_kernels: bool = False
    async_ingest: bool = True  # learn on the background ingest thread
    ingest_max_pending: int = 64  # back-pressure bound on pending ingest batches
    # Smallest serve-path tiles (power-of-two ladder floors).
    min_fill_bucket: int = MIN_FILL_BUCKET
    min_q_bucket: int = MIN_Q_BUCKET


class VerdictEngine:
    def __init__(
        self,
        relation: Relation,
        config: Optional[EngineConfig] = None,
        device=None,
        store=None,
        scan: Optional[ScanPlacement] = None,
        intel=None,
    ):
        self.device = resolve_device(device)
        if relation.device != self.device:
            raise ValueError(
                f"relation lives on {relation.device} but the engine runs on "
                f"{self.device}; build the relation with device={self.device}")
        self.relation = relation
        self.schema: Schema = relation.schema
        self.config = config or EngineConfig()
        # Optional workload-intelligence plane
        # (``repro_torch.intel.WorkloadIntel``): answer cache + serve-path
        # router. None (the default) keeps every path bit for bit the
        # engine without one; the plan lifecycle and the batch executor
        # consult it through ``getattr``, so the core never imports it.
        self.intel = intel
        # The scan plane's placement seam: every block evaluation routes
        # through it, as all learned state routes through ``store``.
        self.scan: ScanPlacement = scan or ScanPlacement()
        self.batches: SampleBatches = build_sample(
            relation,
            rate=self.config.sample_rate,
            n_batches=self.config.n_batches,
            seed=self.config.seed,
        )
        if store is None:
            self.store: SynopsisStore = LocalSynopsisStore(
                self.schema, self.config, self.device)
        elif callable(store) and not isinstance(store, SynopsisStore):
            self.store = store(self.schema, self.config)  # a factory
        else:
            self.store = store
        # The per-block evaluator handed to the placement: the fused scan
        # kernel's wrapper, which launches the kernel on the card and runs
        # its plain version (the plain scan, bit for bit) on the CPU.
        from repro_torch.kernels.fused_masked_scan import ops as fms_ops

        self._eval_fn = fms_ops.eval_partials_fused

    # ------------------------------------------------------------- synopses
    def synopsis_for(self, agg: int, measure: int) -> Synopsis:
        return self.store.for_key(agg_key(agg, measure))

    def drain(self):
        """Barrier over the store's async ingest (snapshot/refit boundary)."""
        self.store.drain()

    def refit(self, steps: int = 150, lr: float = 0.1, learn_sigma: bool = False):
        """Offline learning pass (paper Algorithm 1). Drains async ingest."""
        self.store.refit(steps=steps, lr=lr, learn_sigma=learn_sigma)

    def ingest_stats(self) -> Dict[str, dict]:
        """Per-synopsis async-ingest back-pressure telemetry (structured
        ``"agg<k>-measure<m>"`` keys)."""
        return self.store.ingest_stats()

    def heal(self, manager=None, step: Optional[int] = None) -> Dict[str, bool]:
        """Heal every quarantined synopsis and rejoin it to serving.

        With a ``CheckpointManager`` (or any object exposing
        ``restore_blind(step) -> (states, extra)``), quarantined keys
        restore from the last good committed checkpoint and replay their
        parked batches on top. Without one (or when its restore fails, or
        for keys absent from the checkpoint) they rebuild from their own row
        arrays. Returns ``{state_key: healed}`` for the keys that were
        quarantined.
        """
        states = None
        if manager is not None:
            try:
                states, _ = manager.restore_blind(step)
            except Exception as e:  # noqa: BLE001 — degrade to rebuild
                warnings.warn(
                    f"heal(): checkpoint restore unavailable ({e!r}); "
                    "rebuilding quarantined synopses from row arrays",
                    RuntimeWarning, stacklevel=2,
                )
                states = None
        return self.store.heal(states)

    # ------------------------------------------------------------- groups
    def _discover_groups_many(self, queries: Sequence[Q.AggQuery]):
        """Group-by value discovery for a whole workload in ONE probe.

        Every query's COUNT-probe snippets are fused into a single padded
        batch and evaluated with one ``predicate_mask`` pass over the first
        sample batch. Mask columns are independent per snippet, so the
        discovered groups equal the one-probe-at-a-time path's.
        """
        out: List[Optional[tuple]] = [None] * len(queries)
        need = []
        for i, q in enumerate(queries):
            if not q.groupby:
                out[i] = ((),)
            else:
                need.append(i)
        if not need:
            return out
        with tracing.span("plan.discover", queries=len(need),
                          tuples=len(self.batches.batch_rows[0])):
            first = self.batches.relation.take(self.batches.batch_rows[0])
            plans = [
                Q.decompose(
                    self.schema,
                    Q.AggQuery(aggs=(Q.AggSpec("COUNT"),),
                               predicates=queries[i].predicates),
                )
                for i in need
            ]
            fused = SnippetBatch.concat([p.snippets for p in plans])
            mask_all = to_numpy(
                predicate_mask(first.num_normalized, first.cat,
                               pad_snippets(fused).to(self.device))
            ).astype(bool)
            cat_first = to_numpy(first.cat)
            off = 0
            for i, plan in zip(need, plans):
                q = queries[i]
                mask = mask_all[:, off]
                off += plan.snippets.n
                cats = cat_first[mask][:, list(q.groupby)]
                if cats.size == 0:
                    out[i] = tuple()
                    continue
                uniq = np.unique(cats, axis=0)
                out[i] = tuple(tuple(int(v) for v in row) for row in uniq)
        return out

    # ------------------------------------------------------------- execute
    def execute(
        self,
        q: Q.AggQuery,
        target_rel_error: Optional[float] = None,
        max_batches: Optional[int] = None,
    ) -> QueryResult:
        """One query is a workload of one (``repro_torch.aqp.plan``)."""
        return self.execute_many(
            [q], target_rel_error=target_rel_error, max_batches=max_batches
        )[0]

    def _tuples(self, used_batches: int) -> int:
        return int(sum(len(b) for b in self.batches.batch_rows[:used_batches]))

    def _execute_raw_only(self, q, reason, max_batches):
        """Forced raw-only execution: raw answers over the supported-subset
        probe, no learning, whatever ``q``'s own supportedness (§2.2). The
        lifecycle is the ``supported=False`` branch of ``replay_query``: no
        scan loop lives here. On the card the probe's scan launches the
        fused scan kernel, as every raw-only scan does."""
        from repro_torch.aqp.plan import (LogicalPlan, PhysicalPlan,
                                          SnippetInterner, plain_eval,
                                          replay_query)

        probe = self.raw_only_probe(q)
        groups = self._discover_groups_many([probe])[0]
        plan = Q.decompose(self.schema, probe, groups, n_max=self.config.n_max)
        interner = SnippetInterner(self.schema)
        rows = interner.intern(plan.snippets)
        lp = LogicalPlan(0, q, probe, reason or "forced raw-only", plan, rows)
        phys = PhysicalPlan(self.batches, interner.fused(), plain_eval)
        return replay_query(self, lp, phys, max_batches=max_batches)

    def raw_only_probe(self, q: Q.AggQuery) -> Q.AggQuery:
        """The supported-subset probe the raw-only path evaluates (§2.2)."""
        supported_aggs = tuple(
            a for a in q.aggs if a.kind in Q.SUPPORTED_KINDS
        ) or (Q.AggSpec("COUNT", None),)
        clean_preds = tuple(
            p for p in q.predicates
            if not isinstance(p, (Q.Disjunction, Q.TextLike))
        )
        return Q.AggQuery(aggs=supported_aggs, predicates=clean_preds,
                          groupby=q.groupby)

    # -------------------------------------------------------------- persist
    def synopses_state_dict(self) -> Dict[str, dict]:
        """Host snapshot of the store, keyed ``"agg<k>-measure<m>"`` (numpy
        arrays in the reference's layout)."""
        return self.store.state_dict()

    def load_synopses_state_dict(self, state: Dict[str, dict]):
        """Restore a store snapshot — this package's or the JAX reference's
        ``synopses_state_dict()`` as it is. Σ⁻¹ and α are rebuilt on this
        engine's device, and each key is placed by this engine's store, so
        a snapshot re-places onto any mesh.

        A reserved ``"intel"`` payload (present when the saving engine, of
        either package, had a workload-intelligence plane) restores the
        answer cache and the learned router state when this engine has one
        too — AFTER the store, so cache-entry generations re-license against
        the restored synopses; without one it is left out."""
        state = dict(state)
        intel_state = state.pop("intel", None)
        self.store.load_state_dict(state)
        if self.intel is not None and intel_state is not None:
            self.intel.load_state_dict(intel_state, self.store)

    def save_synopses(self, manager, step: int):
        """Checkpoint the learned synopses (plus, with a workload-
        intelligence plane attached, its answer cache and router state
        under the reserved ``"intel"`` key) through a ``CheckpointManager``:
        one payload, one CRC-verified commit, in the reference's format."""
        payload = self.store.state_dict()
        if self.intel is not None:
            payload["intel"] = self.intel.state_dict(self.store)
        manager.save(step, payload, extra={"kind": "verdict-synopses"})

    def load_synopses(self, manager, step: Optional[int] = None):
        """Restore synopses from a ``CheckpointManager`` checkpoint (this
        package's or the JAX reference's); returns the checkpoint's
        ``extra``.

        This is what makes the engine smarter across process restarts: a new
        process pays zero queries to recover everything past sessions
        learned, re-placed onto whatever devices this engine's store spans,
        and (when both sides carry a workload-intelligence plane) the answer
        cache and router state.
        """
        state, extra = manager.restore_blind(step)
        self.load_synopses_state_dict(state)
        return extra

    # -------------------------------------------------------------- batched
    def execute_many(
        self,
        queries,
        target_rel_error: Optional[float] = None,
        max_batches: Optional[int] = None,
        mesh=None,
        stop_delta: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> List[QueryResult]:
        """Execute a workload through the fused ``BatchExecutor`` path.

        Every sample batch is scanned exactly once for the whole workload
        (identical snippets deduped across queries). ``mesh``: scan over a
        ``Mesh`` for this call (``ShardedScanPlacement``; answers bitwise
        the local scan's) instead of the engine's placement.
        ``stop_delta`` overrides the confidence level of the early-stop
        check; ``deadline_s`` bounds each query's wall clock. With
        ``intel`` attached, cache hits are served before the scan.
        """
        from repro_torch.aqp.batch import BatchExecutor

        return BatchExecutor(self, mesh=mesh).execute_many(
            queries, target_rel_error=target_rel_error,
            max_batches=max_batches, stop_delta=stop_delta,
            deadline_s=deadline_s,
        )
