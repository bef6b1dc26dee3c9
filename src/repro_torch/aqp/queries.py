"""Typed aggregate queries, the support checker, and snippet decomposition.

Mirrors paper §2.2/§2.3 without a SQL parser: a query is SUM/COUNT/AVG
aggregates over a (denormalized) relation with conjunctive range / equality /
IN predicates and an optional group-by on categorical attributes. Unsupported
constructs (disjunctions, LIKE, MIN/MAX) are representable but flagged so the
engine can bypass learning for them — "the class of queries that can be
improved is equivalent to the class that can improve others".

Decomposition (§2.3): every (aggregate × group value) pair becomes one snippet;
group-by values are materialized as equality predicates; at most N_max group
snippets per query get improved answers. Internally only AVG and FREQ exist:
COUNT(*) = FREQ × cardinality, SUM = AVG × COUNT (§2.3 "Aggregate Computation").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.types import (AVG, FREQ, Schema, SnippetBatch,
                                    make_snippets, to_numpy)

N_MAX_DEFAULT = 1000


@dataclasses.dataclass(frozen=True)
class NumRange:
    dim: int
    lo: float
    hi: float


@dataclasses.dataclass(frozen=True)
class NumEq:
    dim: int
    value: float


@dataclasses.dataclass(frozen=True)
class CatIn:
    dim: int
    values: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CatEq:
    dim: int
    value: int


@dataclasses.dataclass(frozen=True)
class Disjunction:
    """Unsupported marker (paper §2.2: no disjunctions)."""

    terms: Tuple


@dataclasses.dataclass(frozen=True)
class TextLike:
    """Unsupported marker (paper §2.2: no textual filters)."""

    pattern: str


@dataclasses.dataclass(frozen=True)
class AggSpec:
    kind: str  # 'AVG' | 'SUM' | 'COUNT' | 'MIN' | 'MAX'
    measure: Optional[int] = None  # None for COUNT(*)


@dataclasses.dataclass(frozen=True)
class AggQuery:
    aggs: Tuple[AggSpec, ...]
    predicates: Tuple = ()
    groupby: Tuple[int, ...] = ()  # categorical dims


SUPPORTED_KINDS = {"AVG", "SUM", "COUNT"}


def unsupported_reason(q: AggQuery) -> Optional[str]:
    """Paper §2.2 support checker; None means supported."""
    for a in q.aggs:
        if a.kind not in SUPPORTED_KINDS:
            return f"aggregate {a.kind} not supported"
    for p in q.predicates:
        if isinstance(p, Disjunction):
            return "disjunctive predicates not supported"
        if isinstance(p, TextLike):
            return "textual filters not supported"
    return None


def predicates_to_arrays(schema: Schema, predicates) -> Tuple[dict, dict]:
    num_ranges, cat_sets = {}, {}
    for p in predicates:
        if isinstance(p, NumRange):
            lo, hi = num_ranges.get(p.dim, (schema.num_lo[p.dim], schema.num_hi[p.dim]))
            num_ranges[p.dim] = (max(lo, p.lo), min(hi, p.hi))
        elif isinstance(p, NumEq):
            # Intersect like NumRange does: overwriting here made the
            # canonical form order-dependent ([NumRange, NumEq] vs
            # [NumEq, NumRange] produced different boxes for the same
            # conjunction), which broke snippet dedup and cache keys for
            # commutative spellings of one query.
            lo, hi = num_ranges.get(p.dim, (schema.num_lo[p.dim], schema.num_hi[p.dim]))
            num_ranges[p.dim] = (max(lo, p.value), min(hi, p.value))
        elif isinstance(p, CatIn):
            prev = cat_sets.get(p.dim)
            vals = set(p.values) if prev is None else set(prev) & set(p.values)
            cat_sets[p.dim] = tuple(sorted(vals))
        elif isinstance(p, CatEq):
            prev = cat_sets.get(p.dim)
            vals = {p.value} if prev is None else set(prev) & {p.value}
            cat_sets[p.dim] = tuple(sorted(vals))
        else:
            raise ValueError(f"unsupported predicate {p}")
    return num_ranges, cat_sets


@dataclasses.dataclass(frozen=True)
class SnippetPlan:
    """How a query's output cells map onto internal AVG/FREQ snippets.

    snippets: one SnippetBatch covering all (group × needed-internal-agg) cells.
    cells: list of (group_index, agg_index, kind, avg_row, freq_row); avg_row /
    freq_row are row ids into ``snippets`` or -1.
    groups: list of group-value tuples (empty tuple when no group-by).
    truncated_groups: discovered group-by values dropped by the ``n_max`` cap
    — recorded so callers (``QueryResult``, ``Session.explain``) can see that
    the result covers a prefix of the full group set instead of silently
    missing cells.
    """

    snippets: SnippetBatch
    cells: Tuple
    groups: Tuple
    truncated_groups: int = 0


def decompose(
    schema: Schema,
    q: AggQuery,
    group_values: Sequence[Tuple[int, ...]] = ((),),
    n_max: int = N_MAX_DEFAULT,
) -> SnippetPlan:
    """Decompose a supported query into snippets (paper Figure 3).

    ``group_values``: the distinct group-by value tuples present in the result
    set (obtained from the AQP engine's sample scan), capped at n_max groups.
    """
    num_ranges, cat_sets = predicates_to_arrays(schema, q.predicates)
    all_groups = tuple(group_values)
    groups = all_groups[:n_max]
    truncated = len(all_groups) - len(groups)

    need_avg = [a.kind in ("AVG", "SUM") and a.measure is not None for a in q.aggs]
    need_freq = [a.kind in ("SUM", "COUNT") for a in q.aggs]

    rows_num, rows_cat, rows_agg, rows_measure = [], [], [], []
    cells = []

    def add_row(nr, cs, agg, measure):
        rows_num.append(dict(nr))
        rows_cat.append(dict(cs))
        rows_agg.append(agg)
        rows_measure.append(measure)
        return len(rows_agg) - 1

    for gi, gv in enumerate(groups):
        cs = dict(cat_sets)
        for dim, val in zip(q.groupby, gv):
            cs[dim] = (int(val),)
        freq_row_cache = None
        avg_row_cache = {}
        for ai, a in enumerate(q.aggs):
            avg_row = -1
            freq_row = -1
            if need_avg[ai]:
                if a.measure not in avg_row_cache:
                    avg_row_cache[a.measure] = add_row(num_ranges, cs, AVG, a.measure)
                avg_row = avg_row_cache[a.measure]
            if need_freq[ai]:
                if freq_row_cache is None:
                    freq_row_cache = add_row(num_ranges, cs, FREQ, 0)
                freq_row = freq_row_cache
            cells.append((gi, ai, a.kind, avg_row, freq_row))

    snippets = make_snippets(
        schema,
        agg=rows_agg,
        measure=rows_measure,
        num_ranges=rows_num,
        cat_sets=rows_cat,
    )
    return SnippetPlan(snippets=snippets, cells=tuple(cells), groups=groups,
                       truncated_groups=truncated)


def assemble_results(plan: SnippetPlan, theta, beta2, cardinality: int):
    """Combine snippet answers into query-cell answers.

    SUM = AVG × COUNT with first-order (delta-method) error propagation;
    COUNT = FREQ × |r| (paper §2.3).
    Returns list of dicts per output cell.
    """
    theta = to_numpy(theta)
    beta2 = to_numpy(beta2)
    out = []
    for gi, ai, kind, avg_row, freq_row in plan.cells:
        if kind == "AVG":
            est, var = theta[avg_row], beta2[avg_row]
        elif kind == "COUNT":
            est = theta[freq_row] * cardinality
            var = beta2[freq_row] * cardinality**2
        else:  # SUM
            avg, freq = theta[avg_row], theta[freq_row]
            est = avg * freq * cardinality
            var = (
                beta2[avg_row] * (freq * cardinality) ** 2
                + beta2[freq_row] * (avg * cardinality) ** 2
            )
        out.append(
            {
                "group": plan.groups[gi],
                "agg": ai,
                "kind": kind,
                "estimate": float(est),
                "beta2": float(max(var, 0.0)),
            }
        )
    return out
