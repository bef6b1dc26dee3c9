"""Typed query builder: column names in, ``AggQuery`` out.

No SQL parser — predicates are built with small helper constructors
(``between``, ``equals``, ``one_of``, ``matches``, ``any_of``) that carry
column *names*; ``QueryBuilder.build`` resolves names to dimension indices
via the relation's ``Schema`` (``num_names`` / ``cat_names`` /
``measure_names``) and emits the engine-level ``AggQuery``. Unsupported
constructs (LIKE, disjunctions, MIN/MAX) are representable and flagged by
the engine's support checker, exactly as in paper §2.2.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

from repro_torch.aqp import queries as Q
from repro_torch.core.types import Schema

ColumnRef = Union[str, int]


@dataclasses.dataclass(frozen=True)
class _Between:
    column: ColumnRef
    lo: float
    hi: float


@dataclasses.dataclass(frozen=True)
class _Equals:
    column: ColumnRef
    value: object


@dataclasses.dataclass(frozen=True)
class _OneOf:
    column: ColumnRef
    values: Tuple


@dataclasses.dataclass(frozen=True)
class _Matches:
    pattern: str


@dataclasses.dataclass(frozen=True)
class _AnyOf:
    terms: Tuple


def between(column: ColumnRef, lo: float, hi: float) -> _Between:
    """Numeric range predicate: lo <= column <= hi."""
    return _Between(column, float(lo), float(hi))


def equals(column: ColumnRef, value) -> _Equals:
    """Equality on a numeric or categorical column, referenced by name
    (a bare index is rejected as ambiguous between the two kinds)."""
    return _Equals(column, value)


def one_of(column: ColumnRef, values: Sequence) -> _OneOf:
    """Categorical IN-list predicate."""
    return _OneOf(column, tuple(values))


def matches(pattern: str) -> _Matches:
    """Textual LIKE filter — representable but unsupported (§2.2)."""
    return _Matches(pattern)


def any_of(*terms) -> _AnyOf:
    """Disjunction — representable but unsupported (§2.2)."""
    return _AnyOf(tuple(terms))


def _resolve(names: Tuple[str, ...], ref: ColumnRef, what: str) -> int:
    if isinstance(ref, int):
        return ref
    try:
        return names.index(ref)
    except ValueError:
        raise KeyError(
            f"unknown {what} column {ref!r}; available: {list(names)}"
        ) from None


class QueryBuilder:
    """Fluent builder for one aggregate query over a schema.

    >>> q = (session.query().avg("v0")
    ...             .where(between("x0", 2, 8))
    ...             .group_by("c0"))

    Builders are executable wherever the Session takes a query; ``build()``
    returns the underlying ``AggQuery``.
    """

    def __init__(self, schema: Schema):
        self._schema = schema
        self._aggs = []
        self._preds = []
        self._groupby = []

    # ------------------------------------------------------------ aggregates
    def _agg(self, kind: str, measure) -> "QueryBuilder":
        idx = (None if measure is None
               else _resolve(self._schema.measure_names, measure, "measure"))
        self._aggs.append(Q.AggSpec(kind, idx))
        return self

    def avg(self, measure: ColumnRef) -> "QueryBuilder":
        return self._agg("AVG", measure)

    def sum(self, measure: ColumnRef) -> "QueryBuilder":
        return self._agg("SUM", measure)

    def count(self) -> "QueryBuilder":
        return self._agg("COUNT", None)

    def min(self, measure: ColumnRef) -> "QueryBuilder":
        """Representable but unsupported — the engine answers raw-only."""
        return self._agg("MIN", measure)

    def max(self, measure: ColumnRef) -> "QueryBuilder":
        """Representable but unsupported — the engine answers raw-only."""
        return self._agg("MAX", measure)

    # ------------------------------------------------------------ predicates
    def where(self, *predicates) -> "QueryBuilder":
        self._preds.extend(predicates)
        return self

    def group_by(self, *columns: ColumnRef) -> "QueryBuilder":
        self._groupby.extend(columns)
        return self

    # ----------------------------------------------------------------- build
    def _lower_predicate(self, p):
        sch = self._schema
        if isinstance(p, _Between):
            return Q.NumRange(_resolve(sch.num_names, p.column, "numeric"),
                              p.lo, p.hi)
        if isinstance(p, _Equals):
            if isinstance(p.column, str) and p.column in sch.cat_names:
                return Q.CatEq(sch.cat_names.index(p.column), int(p.value))
            if isinstance(p.column, str) and p.column in sch.num_names:
                return Q.NumEq(sch.num_names.index(p.column), float(p.value))
            if isinstance(p.column, int):
                # A bare index cannot disambiguate numeric vs categorical
                # dimensions; silently guessing would filter the wrong
                # column. Require a name here (or use Q.NumEq/Q.CatEq).
                raise KeyError(
                    f"equals({p.column!r}, ...) is ambiguous: pass a column "
                    "name, or use repro_torch.aqp.queries.NumEq/CatEq"
                )
            raise KeyError(
                f"unknown column {p.column!r}; numeric: {list(sch.num_names)}"
                f", categorical: {list(sch.cat_names)}"
            )
        if isinstance(p, _OneOf):
            return Q.CatIn(_resolve(sch.cat_names, p.column, "categorical"),
                           tuple(int(v) for v in p.values))
        if isinstance(p, _Matches):
            return Q.TextLike(p.pattern)
        if isinstance(p, _AnyOf):
            return Q.Disjunction(
                tuple(self._lower_predicate(t) for t in p.terms)
            )
        # Already an engine-level predicate — pass through.
        return p

    def build(self) -> Q.AggQuery:
        if not self._aggs:
            raise ValueError("query has no aggregates; call .avg/.sum/.count")
        return Q.AggQuery(
            aggs=tuple(self._aggs),
            predicates=tuple(self._lower_predicate(p) for p in self._preds),
            groupby=tuple(
                _resolve(self._schema.cat_names, c, "group-by")
                for c in self._groupby
            ),
        )
