"""Workload intelligence: the fourth serving plane (`repro_torch.intel`).

The engine already learns across queries at the *model* level (synopses);
this package learns across queries at the *workload* level, closing the
"database that becomes smarter every time" loop at serving:

- ``cache``: a plan-IR-keyed semantic answer cache with subsumption lookup
  and error-budget-aware staleness (generation counters threaded from
  ``Synopsis``);
- ``router``: a per-query serve-path router (cache / synopsis improve /
  full scan) with a deterministic online cost model, plus the learned
  bucket-ladder floors replacing the static ``EngineConfig`` minimums;
- ``telemetry``: the hit/miss/subsumption/staleness/route counters behind
  ``Session.stats()["intel"]`` and ``explain()``.

``WorkloadIntel`` bundles the three and is what
``repro_torch.verdict.connect(cache=...)`` attaches to the engine
(``VerdictEngine.intel``). Everything here is strictly additive: with no
intel plane attached (the default) the engine behaves bit-for-bit as
before, and a cache miss answers bitwise as the engine with the same router
and no cache (``tests/test_torch_intel.py``; ``chip_smoke.py`` phase 7 on
the card). A router's "scan" route answers from the full batch budget
where an always-improving engine may stop early.

The plane is host code: a hit launches no kernel and copies nothing from
the device; a miss runs the engine's unchanged lifecycle. Its state (cache
entries, router statistics, counters) persists as the JAX package's
``"intel"`` checkpoint payload, byte for byte the same JSON layout, so either
package's payload loads in the other.

Determinism: no wall-clock and no RNG anywhere in cache-key or
router-feature derivation — keys persist across processes and route
decisions replay deterministically.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from repro_torch.intel.cache import AnswerCache, CacheEntry, QuerySignature
from repro_torch.intel.router import RouterConfig, ServeRouter
from repro_torch.intel.telemetry import IntelTelemetry

__all__ = [
    "AnswerCache",
    "CacheEntry",
    "IntelConfig",
    "IntelTelemetry",
    "QuerySignature",
    "RouterConfig",
    "ServeRouter",
    "WorkloadIntel",
]


@dataclasses.dataclass
class IntelConfig:
    capacity: int = 256  # answer-cache entries (LRU beyond this)
    subsumption: bool = True
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)


class WorkloadIntel:
    """The workload-intelligence plane of one engine (cache+router+counters).

    Single-threaded like the engine's serve path; attach one instance per
    engine (``repro_torch.verdict.connect(cache=True)``).
    """

    def __init__(self, config: Optional[IntelConfig] = None):
        self.config = config or IntelConfig()
        self.telemetry = IntelTelemetry()
        self.cache = AnswerCache(capacity=self.config.capacity,
                                 subsumption=self.config.subsumption)
        self.router = ServeRouter(self.config.router)

    # ------------------------------------------------------------- serving
    @staticmethod
    def _budget(engine, stop_delta, max_batches) -> Tuple[float, int]:
        delta = (engine.config.report_delta if stop_delta is None
                 else float(stop_delta))
        eff = min(max_batches or engine.batches.n_batches,
                  engine.batches.n_batches)
        return delta, eff

    def lookup(self, engine, query, target_rel_error: Optional[float] = None,
               stop_delta: Optional[float] = None,
               max_batches: Optional[int] = None,
               tenant: Optional[str] = None):
        """Serve ``query`` from the answer cache, or None (execute it).

        ``tenant``: optional label (a session's tenant) — counted in
        ``telemetry.per_tenant`` so a shared cache still reports per-tenant
        hit rates."""
        sig = QuerySignature.from_query(engine.schema, query)
        if sig is None:
            self.telemetry.lookups += 1
            self.telemetry.misses += 1
            self.telemetry.uncacheable += 1
            if tenant is not None:
                self.telemetry.record_tenant(tenant, hit=False)
            return None
        delta, eff = self._budget(engine, stop_delta, max_batches)
        res = self.cache.lookup(engine.store, sig, target_rel_error, delta,
                                eff, telemetry=self.telemetry)
        if res is not None:
            self.telemetry.record_route("cache")
        if tenant is not None:
            self.telemetry.record_tenant(tenant, hit=res is not None)
        return res

    def peek(self, engine, query, target_rel_error: Optional[float] = None,
             stop_delta: Optional[float] = None,
             max_batches: Optional[int] = None,
             lp=None) -> Tuple[str, str]:
        """Read-only (status, route) prediction for ``explain()`` — no
        counters, no LRU movement, no probe-streak mutation."""
        sig = QuerySignature.from_query(engine.schema, query)
        if sig is None:
            return "uncacheable", "scan"
        delta, eff = self._budget(engine, stop_delta, max_batches)
        res = self.cache.lookup(engine.store, sig, target_rel_error, delta,
                                eff, mutate=False)
        if res is not None:
            status = ("exact" if res.served_from == "cache:exact"
                      else "subsumed")
            return status, "cache"
        if lp is None or not lp.supported or lp.plan is None:
            return "miss", "scan" if target_rel_error is None else "improve"
        return "miss", self.router.predict_route(
            engine, lp, target_rel_error, eff)

    def choose_route(self, engine, lp, target_rel_error: Optional[float],
                     max_batches: int) -> str:
        return self.router.choose_route(engine, lp, target_rel_error,
                                        max_batches)

    def observe(self, engine, lp, res, target_rel_error: Optional[float],
                max_batches: int, route: str):
        """Final-round bookkeeping for one executed query: route counters,
        router statistics (and the periodic ladder application), and the
        answer-cache insert. Runs right after ``store.record`` in the plan
        lifecycle, so the generation snapshot includes the answer's own
        ingest bump."""
        self.telemetry.record_route(route)
        if lp.supported:
            self.router.observe(engine, lp, res, target_rel_error, route)
            sig = QuerySignature.from_query(engine.schema, lp.query)
            if sig is not None:
                self.cache.insert(engine.store, sig, lp, res,
                                  target_rel_error, max_batches,
                                  telemetry=self.telemetry)

    # -------------------------------------------------------------- persist
    def state_dict(self, store) -> dict:
        """One ``"blob"`` uint8 array (canonical JSON) — rides the same
        np.savez + CRC checkpoint payload the synopses use."""
        payload = {
            "cache": self.cache.state_dict(store),
            "router": self.router.state_dict(),
            "telemetry": self.telemetry.state_dict(),
        }
        raw = json.dumps(payload, sort_keys=True).encode()
        return {"blob": np.frombuffer(raw, dtype=np.uint8)}

    def load_state_dict(self, state: dict, store):
        blob = np.asarray(state["blob"], dtype=np.uint8)
        payload = json.loads(bytes(blob).decode())
        self.cache.load_state_dict(payload.get("cache", {}), store)
        self.router.load_state_dict(payload.get("router", {}))
        self.telemetry.load_state_dict(payload.get("telemetry", {}))

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        out = self.telemetry.as_dict()
        out["enabled"] = True
        out["entries"] = len(self.cache)
        out["capacity"] = self.cache.capacity
        out["router"] = self.router.stats()
        return out
