"""The multi-tenant serving front: tenants, admission, routing, stats.

``ServingFront`` turns the single-engine ``AqpService`` microbatcher into a
real multi-tenant server. Each ``TenantSpec`` declares its isolation mode:

- ``"shared"`` tenants attach to ONE engine (``Session.attached``), so they
  read and write the same ``SynopsisStore`` and ``WorkloadIntel`` namespace
  — a query learned by tenant A makes tenant B's next repeat cheaper. All
  shared services serialize on one engine lock; the workload-intel plane
  still splits hit-rates per tenant (``IntelTelemetry.per_tenant``).
- ``"isolated"`` tenants get their own engine/Session: private learned
  state, private answer cache, and scans that run in parallel with every
  other tenant.

Every request passes the tenant's ``AdmissionController`` first (token
bucket + bounded queue depth, typed ``Rejection``), then routes through the
tenant's microbatching ``AqpService`` — so the miss path is EXACTLY the
``BatchExecutor`` lifecycle ``Session.execute`` runs, and answers are
bitwise-identical to a direct session call (pinned by
``tests/test_torch_front.py``).

Every engine runs on the relation's device. The front is host code: on the
card a flush's misses launch what every fused workload launches (the fused
scan, the improve kernel, the SE-covariance kernels), and a pre-screened
hit launches nothing.

This module is the composition/transport boundary, so it MAY read the wall
clock — but only to feed timestamps into the clock-free ``admission`` and
``metrics`` modules (analysis rule A008 holds there). Pass ``clock=`` to
replay admission decisions against a scripted clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional

from repro_torch.core.engine import EngineConfig
from repro_torch.serving.front.admission import (
    AdmissionConfig,
    AdmissionController,
    Rejection,
)
from repro_torch.serving.front.metrics import TenantMetrics
from repro_torch.verdict.session import ErrorBudget, Session, connect


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract.

    isolation: ``"shared"`` (one learned-state namespace for all shared
        tenants) or ``"isolated"`` (private engine + store + cache).
    rate / burst / max_pending: admission knobs (see ``AdmissionConfig``).
    budget: the default ``ErrorBudget`` applied to this tenant's
        microbatched queries (per-request budgets override it).
    max_batch: the tenant's microbatch auto-flush threshold.
    """

    name: str
    isolation: str = "shared"
    rate: float = 50.0
    burst: int = 20
    max_pending: int = 256
    budget: Optional[ErrorBudget] = None
    max_batch: int = 64

    def __post_init__(self):
        if self.isolation not in ("shared", "isolated"):
            raise ValueError(
                f"isolation must be 'shared' or 'isolated', "
                f"got {self.isolation!r}")

    def admission(self) -> AdmissionConfig:
        return AdmissionConfig(rate=self.rate, burst=self.burst,
                               max_pending=self.max_pending)


class Tenant:
    """One registered tenant: session + service + admission + metrics."""

    def __init__(self, spec: TenantSpec, session: Session, engine_lock,
                 now: float):
        self.spec = spec
        self.session = session
        self.service = session.serve(max_batch=spec.max_batch,
                                     budget=spec.budget,
                                     engine_lock=engine_lock)
        self.admission = AdmissionController(spec.name, spec.admission(),
                                             now=now)
        self.metrics = TenantMetrics(spec.name)

    def stats(self) -> dict:
        svc = self.service
        return {
            "isolation": self.spec.isolation,
            "admission": self.admission.stats(),
            "metrics": self.metrics.snapshot(),
            "service": {
                "flushes": svc.flushes,
                "pending": svc.pending,
                "prescreened": svc.prescreened,
            },
            "health": {
                "quarantined": self.session.store.quarantined(),
            },
        }


class ServingFront:
    """Multi-tenant serving front over one relation.

    One front owns the shared engine (created on first shared tenant) and
    every isolated tenant's private engine. ``cache=True`` (default)
    attaches a ``WorkloadIntel`` plane to each engine, so repeat queries
    prescreen at submit; shared tenants share one cache namespace with
    per-tenant hit counters.

    ``clock``: the monotonic time source feeding admission and latency
    metrics (``time.monotonic`` by default). Inject a fake for
    deterministic admission replay.
    """

    def __init__(self, relation, config: Optional[EngineConfig] = None,
                 mesh=None, cache=True, clock=time.monotonic):
        self._relation = relation
        self._config = config
        self._mesh = mesh
        self._cache = cache
        self.clock = clock
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.Lock()
        self._shared_session: Optional[Session] = None
        # One engine lock for ALL services over the shared engine: flushes
        # and prescreen lookups across shared tenants serialize here.
        self._shared_engine_lock = threading.Lock()

    # --------------------------------------------------------------- tenants
    def add_tenant(self, spec) -> Tenant:
        """Register a tenant (a ``TenantSpec`` or just a name)."""
        if isinstance(spec, str):
            spec = TenantSpec(spec)
        with self._lock:
            if spec.name in self._tenants:
                raise ValueError(f"tenant {spec.name!r} already registered")
            now = self.clock()
            if spec.isolation == "shared":
                if self._shared_session is None:
                    self._shared_session = connect(
                        self._relation, self._config, mesh=self._mesh,
                        cache=self._cache)
                session = Session.attached(self._shared_session,
                                           tenant=spec.name)
                tenant = Tenant(spec, session, self._shared_engine_lock, now)
            else:
                session = connect(self._relation, self._config,
                                  cache=self._cache, tenant=spec.name)
                tenant = Tenant(spec, session, None, now)
            self._tenants[spec.name] = tenant
            return tenant

    def tenant(self, name: str) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; registered: "
                f"{sorted(self._tenants)}") from None

    @property
    def tenants(self) -> Dict[str, Tenant]:
        return dict(self._tenants)

    # --------------------------------------------------------------- serving
    def _admit(self, tenant: Tenant) -> Optional[Rejection]:
        rejection = tenant.admission.admit(self.clock(),
                                           tenant.service.pending)
        if rejection is not None:
            tenant.metrics.record_rejection(rejection)
        return rejection

    def execute(self, name: str, query, budget: Optional[ErrorBudget] = None):
        """Run one query for ``name``; returns an answer-ladder value.

        ``Rejection`` (admission refused — the query never executed),
        ``QueryAnswer`` (possibly ``degraded``), or ``FailedAnswer``
        (terminal fault after the service's retry+bisect ladder). With no
        per-request ``budget``, the query rides the tenant's microbatch
        service (coalescing with concurrent submitters under the tenant's
        default budget); an explicit budget executes directly through the
        tenant's session under the same engine lock.
        """
        tenant = self.tenant(name)
        rejection = self._admit(tenant)
        if rejection is not None:
            return rejection
        t0 = self.clock()
        if budget is None:
            ans = tenant.service.submit(query).result()
        else:
            with tenant.service._exec_lock:
                ans = tenant.session.execute(query, budget=budget)
        pre = (getattr(ans, "served_from", None) or "").startswith("cache:")
        tenant.metrics.record_outcome(ans, self.clock() - t0, op="execute",
                                      prescreened=pre)
        return ans

    def explain(self, name: str, query,
                budget: Optional[ErrorBudget] = None):
        """Plan report for ``name``'s query (read-only; still admitted,
        still serialized on the engine lock — it reads shared store
        state)."""
        tenant = self.tenant(name)
        rejection = self._admit(tenant)
        if rejection is not None:
            return rejection
        t0 = self.clock()
        with tenant.service._exec_lock:
            report = tenant.session.explain(query, budget=budget)
        tenant.metrics.record_outcome(report, self.clock() - t0, op="explain")
        return report

    def stream(self, name: str, query,
               budget: Optional[ErrorBudget] = None) -> Iterator:
        """Online-aggregation stream: per-batch refined ``QueryAnswer``s.

        Yields ``session.stream``'s refinements (last one ``final=True``,
        bit-for-bit the ``execute`` answer under the same budget wherever
        the serve-path router would route that execute "improve": a stream
        never consults the router, as in the reference). A
        ``Rejection`` is yielded alone when admission refuses. The whole
        stream holds the engine lock — a shared tenant's stream serializes
        with its neighbors exactly like any other engine access.
        """
        tenant = self.tenant(name)
        rejection = self._admit(tenant)
        if rejection is not None:
            yield rejection
            return
        t0 = self.clock()
        rounds = 0
        with tenant.service._exec_lock:
            for ans in tenant.session.stream(query, budget=budget):
                rounds += 1
                yield ans
        tenant.metrics.record_stream(rounds, self.clock() - t0)

    # ----------------------------------------------------------------- stats
    def stats(self, name: Optional[str] = None) -> dict:
        """Per-tenant observability (one tenant, or all + front totals).

        Each tenant block: admission counters (admitted / typed rejections
        by reason), outcome counters + latency histograms, microbatch
        service counters, quarantine state. The front block adds the shared
        intel plane's per-tenant hit rates.
        """
        if name is not None:
            return self.tenant(name).stats()
        shared = self._shared_session
        intel = shared.intel.stats() if (shared is not None
                                         and shared.intel is not None) else {
            "enabled": False}
        return {
            "tenants": {n: t.stats() for n, t in sorted(self._tenants.items())},
            "shared_intel": intel,
        }
