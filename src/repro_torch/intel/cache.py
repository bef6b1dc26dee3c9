"""Plan-IR-keyed semantic answer cache with subsumption serving.

Past answers make future queries cheaper at the synopsis; this cache closes
the loop at the *answer* level: the final ``QueryResult`` of every
supported query is stored under a canonical key derived from the same
logical-plan content the snippet interner dedups on, and later queries that
are semantically equal (or subsumed, see below) are served without scanning
at all. An entry holds plain Python floats, so a hit touches no device.

Cache key derivation
    ``QuerySignature.from_query`` canonicalizes a query through
    ``predicates_to_arrays`` — the SAME canonical predicate-box form the
    snippet decomposition uses — so commutative conjunctions, reordered
    ``one_of`` sets, duplicated predicates and explicit-full-range spellings
    all produce one signature. The key is a BLAKE2b digest of the
    signature's canonical JSON: deterministic across processes (never
    Python's salted ``hash()``), so persisted caches rehydrate onto the same
    keys, and equal to the JAX package's digest of the same query, so a
    cache persisted by either package loads in the other. No wall-clock, no
    RNG.

Subsumption rule (servable from cached entry C for new query N)
    - identical aggregate list; C recorded no truncated groups;
    - numeric boxes equal per-dimension within ``RANGE_EPS`` (the scan
      plane's single predicate epsilon — a bound within eps of a cached
      bound selects the same tuples by construction of ``predicate_mask``);
    - on non-grouped categorical dims, identical constraint sets;
    - ``N.groupby`` is an order-preserving subsequence of ``C.groupby``;
      every dim C grouped by that N dropped must be pinned to a single
      value in N, and N's sets on grouped dims must be subsets of C's.
    The served cells are then literally C's recorded cells, filtered to N's
    member groups and projected onto N's group-by dims — "exactly
    reproducible from the recorded cached cells" is true by construction.

Staleness semantics (error-budget-aware invalidation)
    Every entry snapshots the ``Synopsis.generation`` of each aggregate key
    it touched (bumped on the caller's thread on ingest enqueue, refit,
    append, heal and restore, and on quarantine).
    A quarantined key always refuses. A fresh entry serves when the
    caller's budget is satisfied. A staleness-bumped entry serves ONLY to
    callers with an explicit ``target_rel_error`` whose recorded CI still
    meets it — the error budget licenses bounded staleness; full-accuracy
    callers (no target) get a miss and a fresh answer.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.aqp import queries as Q
from repro_torch.aqp.plan import QueryResult
from repro_torch.core.store import group_rows, parse_state_key, state_key
from repro_torch.intel.telemetry import IntelTelemetry
from repro_torch.kernels import RANGE_EPS
from repro_torch.utils.stats import confidence_multiplier


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """Canonical content of one supported query (the cache-key basis).

    ``num_lo``/``num_hi`` carry the full per-dimension box (schema bounds
    where unconstrained), ``cat_sets`` the full sorted member set per
    categorical dim — so syntactically different spellings of one predicate
    conjunction collapse to one signature.
    """

    aggs: Tuple[Tuple[str, int], ...]  # (kind, measure; -1 when irrelevant)
    groupby: Tuple[int, ...]
    num_lo: Tuple[float, ...]
    num_hi: Tuple[float, ...]
    cat_sets: Tuple[Tuple[int, ...], ...]

    @staticmethod
    def from_query(schema, q: Q.AggQuery) -> Optional["QuerySignature"]:
        """Canonical signature, or None when the query is uncacheable
        (unsupported constructs never enter the cache — they serve raw)."""
        if Q.unsupported_reason(q) is not None:
            return None
        num_ranges, cat_sets = Q.predicates_to_arrays(schema, q.predicates)
        aggs = tuple(
            (a.kind, -1 if (a.measure is None or a.kind == "COUNT")
             else int(a.measure))
            for a in q.aggs
        )
        num_lo, num_hi = [], []
        for d in range(schema.n_num):
            lo, hi = num_ranges.get(d, (schema.num_lo[d], schema.num_hi[d]))
            num_lo.append(float(lo))
            num_hi.append(float(hi))
        cats = tuple(
            tuple(int(v) for v in cat_sets.get(d, range(schema.cat_sizes[d])))
            for d in range(schema.n_cat)
        )
        return QuerySignature(
            aggs=aggs,
            groupby=tuple(int(d) for d in q.groupby),
            num_lo=tuple(num_lo),
            num_hi=tuple(num_hi),
            cat_sets=cats,
        )

    def to_jsonable(self) -> list:
        return [list(map(list, self.aggs)), list(self.groupby),
                list(self.num_lo), list(self.num_hi),
                [list(s) for s in self.cat_sets]]

    @staticmethod
    def from_jsonable(obj) -> "QuerySignature":
        aggs, groupby, lo, hi, cats = obj
        return QuerySignature(
            aggs=tuple((str(k), int(m)) for k, m in aggs),
            groupby=tuple(int(d) for d in groupby),
            num_lo=tuple(float(v) for v in lo),
            num_hi=tuple(float(v) for v in hi),
            cat_sets=tuple(tuple(int(v) for v in s) for s in cats),
        )

    def digest(self) -> str:
        payload = json.dumps(self.to_jsonable(), separators=(",", ":"))
        return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


@dataclasses.dataclass
class CacheEntry:
    """One recorded final answer plus the state snapshot that licensed it."""

    key: str
    sig: QuerySignature
    cells: Tuple[dict, ...]
    batches_used: int
    tuples_scanned: int
    truncated_groups: int
    gens: Tuple[Tuple[str, int], ...]  # (state_key, generation) at record
    target: Optional[float]  # error budget it was recorded under
    max_batches: int  # effective batch budget at record time
    hits: int = 0

    def to_jsonable(self) -> dict:
        return {
            "key": self.key,
            "sig": self.sig.to_jsonable(),
            "cells": [dict(c, group=list(c["group"])) for c in self.cells],
            "batches_used": self.batches_used,
            "tuples_scanned": self.tuples_scanned,
            "truncated_groups": self.truncated_groups,
            "gens": [[n, g] for n, g in self.gens],
            "target": self.target,
            "max_batches": self.max_batches,
            "hits": self.hits,
        }

    @staticmethod
    def from_jsonable(obj: dict) -> "CacheEntry":
        return CacheEntry(
            key=str(obj["key"]),
            sig=QuerySignature.from_jsonable(obj["sig"]),
            cells=tuple(
                dict(c, group=tuple(int(v) for v in c["group"]))
                for c in obj["cells"]
            ),
            batches_used=int(obj["batches_used"]),
            tuples_scanned=int(obj["tuples_scanned"]),
            truncated_groups=int(obj["truncated_groups"]),
            gens=tuple((str(n), int(g)) for n, g in obj["gens"]),
            target=None if obj["target"] is None else float(obj["target"]),
            max_batches=int(obj["max_batches"]),
            hits=int(obj["hits"]),
        )


def _max_rel_error(cells, delta: float) -> float:
    alpha = float(confidence_multiplier(delta))
    worst = 0.0
    for c in cells:
        denom = max(abs(c["estimate"]), 1e-9)
        worst = max(worst, alpha * float(np.sqrt(c["beta2"])) / denom)
    return worst


class AnswerCache:
    """LRU semantic answer cache (see module docstring for the contracts)."""

    def __init__(self, capacity: int = 256, subsumption: bool = True):
        self.capacity = int(capacity)
        self.subsumption = bool(subsumption)
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------ freshness
    @staticmethod
    def _freshness(store, entry: CacheEntry) -> Tuple[bool, bool]:
        """(stale, quarantined) of an entry against the live store."""
        stale = quarantined = False
        for name, gen in entry.gens:
            key = parse_state_key(name)
            syn = store.get(key)
            if syn is not None and syn.quarantined:
                quarantined = True
            if store.generation(key) != gen:
                stale = True
        return stale, quarantined

    def _admit(self, store, entry: CacheEntry, cells,
               target: Optional[float], delta: float, max_batches: int,
               refusals: set) -> Tuple[bool, bool]:
        """Serve decision for candidate ``cells`` of ``entry``.

        Returns (serve, stale_served). Collects refusal reasons into
        ``refusals`` ("quarantine" | "stale" | "budget") for telemetry.
        """
        stale, quarantined = self._freshness(store, entry)
        if quarantined:
            refusals.add("quarantine")
            return False, False
        if target is None:
            # Full-accuracy caller: only a fresh entry recorded under the
            # same full batch budget reproduces what the engine would
            # compute now.
            if stale:
                refusals.add("stale")
                return False, False
            if entry.target is not None or entry.batches_used != max_batches:
                refusals.add("budget")
                return False, False
            return True, False
        if _max_rel_error(cells, delta) > target:
            refusals.add("budget")
            if stale:
                refusals.add("stale")
            return False, False
        return True, stale

    # --------------------------------------------------------- subsumption
    @staticmethod
    def _subsumed_cells(entry: CacheEntry,
                        sig: QuerySignature) -> Optional[List[dict]]:
        """C=entry.sig's recorded cells filtered/projected for N=sig, or
        None when N is not servable from C (see module docstring)."""
        c = entry.sig
        if sig.aggs != c.aggs or entry.truncated_groups > 0:
            return None
        for nl, nh, cl, ch in zip(sig.num_lo, sig.num_hi, c.num_lo, c.num_hi):
            if abs(nl - cl) > RANGE_EPS or abs(nh - ch) > RANGE_EPS:
                return None
        grouped = set(c.groupby)
        for d in range(len(sig.cat_sets)):
            if d in grouped:
                if not set(sig.cat_sets[d]) <= set(c.cat_sets[d]):
                    return None
            elif sig.cat_sets[d] != c.cat_sets[d]:
                return None
        # N.groupby must be an order-preserving subsequence of C.groupby,
        # with every dropped grouped dim pinned to a single value in N
        # (AVG cells cannot be merged, only selected).
        it = iter(c.groupby)
        if not all(d in it for d in sig.groupby):
            return None
        dropped = [d for d in c.groupby if d not in set(sig.groupby)]
        if any(len(sig.cat_sets[d]) != 1 for d in dropped):
            return None
        gpos = {d: i for i, d in enumerate(c.groupby)}
        members = {d: set(sig.cat_sets[d]) for d in c.groupby}
        out = []
        for cell in entry.cells:
            gv = cell["group"]
            if all(gv[gpos[d]] in members[d] for d in c.groupby):
                out.append(dict(
                    cell,
                    group=tuple(gv[gpos[d]] for d in sig.groupby),
                ))
        return out or None

    # --------------------------------------------------------------- lookup
    @staticmethod
    def _result(entry: CacheEntry, cells, served_from: str,
                truncated: int) -> QueryResult:
        return QueryResult(
            cells=[dict(c, group=tuple(c["group"])) for c in cells],
            batches_used=entry.batches_used,
            tuples_scanned=entry.tuples_scanned,
            supported=True,
            truncated_groups=truncated,
            served_from=served_from,
        )

    def lookup(self, store, sig: QuerySignature, target: Optional[float],
               delta: float, max_batches: int,
               telemetry: Optional[IntelTelemetry] = None,
               mutate: bool = True) -> Optional[QueryResult]:
        """Serve ``sig`` from the cache, or None (a miss).

        ``mutate=False`` is the ``explain()`` peek: no counters, no LRU
        movement, no hit bookkeeping.
        """
        t = telemetry if (telemetry is not None and mutate) else None
        if t is not None:
            t.lookups += 1
        refusals: set = set()
        key = sig.digest()
        entry = self._entries.get(key)
        if entry is not None and entry.sig == sig:
            ok, stale_served = self._admit(
                store, entry, entry.cells, target, delta, max_batches,
                refusals)
            if ok:
                if t is not None:
                    t.hits_exact += 1
                    t.stale_served += int(stale_served)
                if mutate:
                    entry.hits += 1
                    self._entries.move_to_end(key)
                return self._result(entry, entry.cells, "cache:exact",
                                    entry.truncated_groups)
        if self.subsumption:
            for cand in self._entries.values():
                if cand.key == key:
                    continue
                cells = self._subsumed_cells(cand, sig)
                if cells is None:
                    continue
                ok, stale_served = self._admit(
                    store, cand, cells, target, delta, max_batches, refusals)
                if not ok:
                    continue
                if t is not None:
                    t.hits_subsumed += 1
                    t.stale_served += int(stale_served)
                if mutate:
                    cand.hits += 1
                    self._entries.move_to_end(cand.key)
                return self._result(cand, cells, "cache:subsumed", 0)
        if t is not None:
            t.misses += 1
            t.stale_refused += int("stale" in refusals)
            t.quarantine_refused += int("quarantine" in refusals)
            t.budget_refused += int("budget" in refusals)
        return None

    # --------------------------------------------------------------- insert
    def insert(self, store, sig: QuerySignature, lp, res,
               target: Optional[float], max_batches: int,
               telemetry: Optional[IntelTelemetry] = None):
        """Record a final engine answer (called from the plan lifecycle
        after ``store.record``, so the generation snapshot includes the
        answer's own ingest bump — a repeat is fresh, not self-stale)."""
        if (lp.plan is None or not res.supported or res.degraded
                or res.served_from is not None):
            return
        gens = tuple(
            (state_key(k), store.generation(k))
            for k, _ in group_rows(lp.plan.snippets)
        )
        cells = tuple(
            {
                "group": tuple(int(v) for v in c["group"]),
                "agg": int(c["agg"]),
                "kind": str(c["kind"]),
                "estimate": float(c["estimate"]),
                "beta2": float(c["beta2"]),
            }
            for c in res.cells
        )
        key = sig.digest()
        self._entries[key] = CacheEntry(
            key=key, sig=sig, cells=cells,
            batches_used=int(res.batches_used),
            tuples_scanned=int(res.tuples_scanned),
            truncated_groups=int(res.truncated_groups),
            gens=gens,
            target=None if target is None else float(target),
            max_batches=int(max_batches),
        )
        self._entries.move_to_end(key)
        if telemetry is not None:
            telemetry.insertions += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            if telemetry is not None:
                telemetry.evictions += 1

    # -------------------------------------------------------------- persist
    def state_dict(self, store) -> dict:
        """JSON-serializable snapshot plus the store's per-key generations
        at save time (needed to re-license entries on restore)."""
        return {
            "entries": [e.to_jsonable() for e in self._entries.values()],
            "store_gens": {state_key(k): store.generation(k)
                           for k in store.keys()},
            "capacity": self.capacity,
            "subsumption": self.subsumption,
        }

    def load_state_dict(self, state: dict, store):
        """Restore, remapping generations onto the restored store.

        Generation counters restart per process, so raw restored gens would
        mark everything stale. An entry that was FRESH at save time (its
        gens matched the saved store gens) is remapped to the restored
        store's current generations — cache and store persist in one
        payload, so they are mutually consistent. Entries stale at save
        stay permanently stale (gen -1 never matches).
        """
        self.capacity = int(state.get("capacity", self.capacity))
        self.subsumption = bool(state.get("subsumption", self.subsumption))
        saved_gens = {str(k): int(v)
                      for k, v in dict(state.get("store_gens", {})).items()}
        self._entries = OrderedDict()
        for obj in state.get("entries", []):
            entry = CacheEntry.from_jsonable(obj)
            fresh = all(gen == saved_gens.get(name, 0)
                        for name, gen in entry.gens)
            entry.gens = tuple(
                (name,
                 store.generation(parse_state_key(name)) if fresh else -1)
                for name, _ in entry.gens
            )
            self._entries[entry.key] = entry
