"""JSON wire codec for the serving front.

One request/response vocabulary shared by the HTTP transport and the load
bench: queries arrive as plain JSON and lower through the SAME typed
``QueryBuilder`` the in-process facade uses (so wire queries hit the exact
engine paths session queries do — nothing is re-implemented at the edge),
budgets lower to ``ErrorBudget``, and every rung of the answer ladder
(``QueryAnswer`` / ``FailedAnswer`` / ``Rejection``) serializes to a typed
JSON object discriminated by ``"kind"``.

Query JSON shape::

    {"aggs": [{"kind": "avg", "measure": "v0"}, {"kind": "count"}],
     "where": [{"op": "between", "column": "x0", "lo": 2, "hi": 8},
               {"op": "equals", "column": "c0", "value": 3},
               {"op": "one_of", "column": "c1", "values": [0, 2]}],
     "group_by": ["c0"]}

Budget JSON shape (all keys optional)::

    {"target_rel_error": 0.05, "max_batches": 4, "delta": 0.95,
     "deadline_s": 0.5}
"""
from __future__ import annotations

from typing import Optional

from repro_torch.verdict.answer import FailedAnswer, QueryAnswer
from repro_torch.verdict.query import QueryBuilder, between, equals, one_of
from repro_torch.verdict.session import ErrorBudget


def _plain(v):
    """A JSON-ready value: a numpy scalar or a 0-d ``torch.Tensor`` becomes
    the Python ``int``/``float``/``bool`` it holds (``json.dumps`` refuses
    both); tuples become lists; dicts and lists convert element by element.
    A Python float round-trips through ``json`` bit for bit (``repr``)."""
    if v is None or isinstance(v, (str, bool)):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):  # also np.float64, a float subclass
        return float(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "item"):  # numpy scalar, 0-d torch.Tensor
        return v.item()
    raise TypeError(f"not a JSON value: {type(v).__name__}")


class WireError(ValueError):
    """Malformed request JSON — the transport maps this to HTTP 400."""


_AGG_KINDS = {"avg", "sum", "count", "min", "max"}


def query_from_json(schema, obj: dict) -> QueryBuilder:
    """Lower a query JSON object to a ``QueryBuilder`` over ``schema``.

    Raises ``WireError`` on unknown aggregate kinds, predicate ops, or
    column names (the builder's own ``KeyError`` is re-raised as
    ``WireError`` so the transport can 400 it with the message intact).
    """
    if not isinstance(obj, dict):
        raise WireError(f"query must be a JSON object, got {type(obj).__name__}")
    qb = QueryBuilder(schema)
    aggs = obj.get("aggs")
    if not aggs:
        raise WireError('query needs a non-empty "aggs" list')
    try:
        for a in aggs:
            kind = str(a.get("kind", "")).lower()
            if kind not in _AGG_KINDS:
                raise WireError(
                    f"unknown aggregate kind {kind!r}; "
                    f"expected one of {sorted(_AGG_KINDS)}")
            if kind == "count":
                qb.count()
            else:
                if "measure" not in a:
                    raise WireError(f'aggregate {kind!r} needs a "measure"')
                getattr(qb, kind)(a["measure"])
        for p in obj.get("where", ()):
            op = str(p.get("op", "")).lower()
            if op == "between":
                qb.where(between(p["column"], p["lo"], p["hi"]))
            elif op == "equals":
                qb.where(equals(p["column"], p["value"]))
            elif op == "one_of":
                qb.where(one_of(p["column"], p["values"]))
            else:
                raise WireError(
                    f"unknown predicate op {op!r}; "
                    "expected between | equals | one_of")
        gb = obj.get("group_by", ())
        if gb:
            qb.group_by(*gb)
        qb.build()  # validate eagerly: name resolution errors surface here
    except WireError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed query: {e}") from None
    return qb


def budget_from_json(obj: Optional[dict]) -> Optional[ErrorBudget]:
    """Lower a budget JSON object to an ``ErrorBudget`` (None passes)."""
    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise WireError(
            f"budget must be a JSON object, got {type(obj).__name__}")
    known = {"target_rel_error", "max_batches", "delta", "deadline_s"}
    extra = set(obj) - known
    if extra:
        raise WireError(f"unknown budget keys {sorted(extra)}; "
                        f"expected a subset of {sorted(known)}")
    try:
        return ErrorBudget(
            target_rel_error=(None if obj.get("target_rel_error") is None
                              else float(obj["target_rel_error"])),
            max_batches=(None if obj.get("max_batches") is None
                         else int(obj["max_batches"])),
            delta=(None if obj.get("delta") is None
                   else float(obj["delta"])),
            deadline_s=(None if obj.get("deadline_s") is None
                        else float(obj["deadline_s"])),
        )
    except (TypeError, ValueError) as e:
        raise WireError(f"malformed budget: {e}") from None


def answer_to_json(ans) -> dict:
    """Serialize one answer-ladder value, discriminated by ``"kind"``.

    ``QueryAnswer`` -> ``{"kind": "answer", ...}``;
    ``FailedAnswer`` -> ``{"kind": "failed", ...}``;
    ``Rejection``    -> ``{"kind": "rejected", ...}``.
    """
    if isinstance(ans, QueryAnswer):
        return _plain({
            "kind": "answer",
            "cells": [c.to_dict() for c in ans.cells],
            "batches_used": ans.batches_used,
            "tuples_scanned": ans.tuples_scanned,
            "supported": ans.supported,
            "unsupported_reason": ans.unsupported_reason,
            "truncated_groups": ans.truncated_groups,
            "final": ans.final,
            "degraded": ans.degraded,
            "degraded_reasons": dict(ans.degraded_reasons),
            "served_from": ans.served_from,
        })
    if isinstance(ans, FailedAnswer):
        return {
            "kind": "failed",
            "error": ans.error,
            "error_type": ans.error_type,
            "attempts": ans.attempts,
        }
    # Rejection (duck-typed to avoid a circular import with admission).
    if getattr(ans, "rejected", False):
        return {
            "kind": "rejected",
            "reason": ans.reason,
            "tenant": ans.tenant,
            "retry_after_s": ans.retry_after_s,
            "detail": ans.detail,
        }
    raise TypeError(f"not an answer-ladder value: {type(ans).__name__}")


def report_to_json(report) -> dict:
    """Serialize a ``PlanReport`` (``explain``) — dict keys stringified
    because aggregate keys are tuples; numbers are plain Python numbers."""
    return _plain({
        "kind": "plan",
        "supported": report.supported,
        "unsupported_reason": report.unsupported_reason,
        "n_cells": report.n_cells,
        "n_groups": report.n_groups,
        "truncated_groups": report.truncated_groups,
        "n_snippets": report.n_snippets,
        "n_snippets_unique": report.n_snippets_unique,
        "dedup_ratio": report.dedup_ratio,
        "q_buckets": {str(k): v for k, v in report.q_buckets.items()},
        "fill_buckets": {str(k): v for k, v in report.fill_buckets.items()},
        "placement": {str(k): v for k, v in report.placement.items()},
        "scan_placement": report.scan_placement,
        "scan_evaluator": report.scan_evaluator,
        "quarantined": dict(report.quarantined),
        "cache": report.cache,
        "route": report.route,
    })
