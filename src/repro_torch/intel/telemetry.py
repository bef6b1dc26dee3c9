"""Workload-intelligence counters (`Session.stats()["intel"]`).

One mutable counter block shared by the semantic answer cache
(``repro_torch.intel.cache``) and the serve-path router
(``repro_torch.intel.router``):
every lookup resolves to exactly one of hit-exact / hit-subsumed / miss,
with the refusal sub-reasons (stale / quarantined / budget / uncacheable)
counted alongside so operators can see WHY a repeat query re-scanned.
Route decisions (cache / improve / scan) accumulate per route.

Determinism: these are pure event counters — no wall-clock, no RNG.
Latency lives in the measurements (``chip_smoke.py``), never in serve-path
state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class IntelTelemetry:
    """Hit/miss/staleness/route counters for one ``WorkloadIntel`` plane.

    ``lookups`` counts every cache consult; a lookup lands in exactly one of
    ``hits_exact`` / ``hits_subsumed`` / ``misses``. The ``*_refused``
    counters sub-classify misses by refusal reason (one miss may carry
    several: e.g. an entry both stale and quarantined). ``stale_served``
    counts hits served from a staleness-bumped entry whose recorded CI still
    met the caller's explicit error budget (error-budget-licensed serving).

    ``per_tenant`` splits lookups/hits by the tenant label a session
    threads through (``Session(tenant=)``, ``Session.attached``).
    Unlabeled traffic is not counted here (the aggregate counters above
    already cover it).
    """

    lookups: int = 0
    hits_exact: int = 0
    hits_subsumed: int = 0
    misses: int = 0
    stale_served: int = 0
    stale_refused: int = 0
    quarantine_refused: int = 0
    budget_refused: int = 0
    uncacheable: int = 0
    insertions: int = 0
    evictions: int = 0
    routes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"cache": 0, "improve": 0, "scan": 0})
    per_tenant: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def hits(self) -> int:
        return self.hits_exact + self.hits_subsumed

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def record_route(self, route: str):
        self.routes[route] = self.routes.get(route, 0) + 1

    def record_tenant(self, tenant: str, hit: bool):
        t = self.per_tenant.setdefault(tenant, {"lookups": 0, "hits": 0})
        t["lookups"] += 1
        t["hits"] += int(hit)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hits"] = self.hits
        d["hit_rate"] = self.hit_rate
        d["per_tenant"] = {
            name: dict(t, hit_rate=t["hits"] / max(t["lookups"], 1))
            for name, t in self.per_tenant.items()
        }
        return d

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict):
        for f in dataclasses.fields(self):
            if f.name in state:
                val = state[f.name]
                if f.name == "routes":
                    val = dict(val)
                elif f.name == "per_tenant":
                    val = {str(k): {m: int(n) for m, n in dict(v).items()}
                           for k, v in dict(val).items()}
                else:
                    val = int(val)
                setattr(self, f.name, val)
