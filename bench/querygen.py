"""The one generator of aggregate-query traffic: it reads a mix's
``bench/traffic/<name>.json`` and draws queries from a seeded stream.

A mix lists templates, each with a weight, its aggregates (``[kind,
measure name or null]``), its predicates and its group-by columns. A
predicate on a numeric column is a window ``[start, start + span]`` with
``start ~ U(start[0], start[1])`` and ``span ~ U(span[0], span[1])``, or a
fixed ``[lo, hi]``; one on a categorical column is an equality with a
value drawn uniformly from its domain (``"eq": "uniform"``) or fixed.
Draws follow the order of the file.

Every run asks for the same queries in the same order: the mix's
``"pool": {"seed": s, "size": n}`` gives ``n`` queries from the fixed seed
``s`` (the warm-up its own ``warmup.queries``), and client ``k`` takes the
pool's queries ``k``, ``k + clients``, ... A run's seed draws the data and
the sample, not the work asked for: a window reaches a few queries of each
client's stream, and with a stream that changed with the seed, each seed
would run another handful of the pool.

A query is a plain tuple, ``QuerySpec``: nothing here knows the port's
types, so the reference reads the same queries the program is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

WARMUP_STREAM = 0
CLIENT_STREAM = 1


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """aggs: ((kind, measure index or None), ...); ranges: ((dim, lo, hi),
    ...) in raw units; eqs: ((dim, value), ...); groupby: (dim, ...)."""

    template: str
    aggs: Tuple[Tuple[str, Optional[int]], ...]
    ranges: Tuple[Tuple[int, float, float], ...]
    eqs: Tuple[Tuple[int, int], ...]
    groupby: Tuple[int, ...]


class QueryStream:
    """Queries of one mix against one schema, from one seeded stream.

    With ``"template_order": "cycle"`` in the mix, the templates take turns
    (weights are then ignored); otherwise each query draws its template by
    weight."""

    def __init__(self, mix: dict, schema: dict, seed_words):
        self.templates = mix["templates"]
        w = np.asarray([float(t["weight"]) for t in self.templates])
        if not len(w) or np.any(w <= 0):
            raise ValueError("a mix needs templates with positive weights")
        self.p = w / w.sum()
        self.num = {c["name"]: i for i, c in enumerate(schema["numeric"])}
        self.cat = {c["name"]: i for i, c in enumerate(schema["categorical"])}
        self.cat_size = [int(c["size"]) for c in schema["categorical"]]
        self.measure = {m: i for i, m in enumerate(schema["measures"])}
        self.rng = np.random.default_rng(list(seed_words))
        self.cycle = mix.get("template_order") == "cycle"
        self.turn = 0

    def _agg(self, kind, measure):
        if kind not in ("SUM", "AVG", "COUNT"):
            raise ValueError(f"aggregate {kind} is not in the mix's language")
        return (kind, None if measure is None else self.measure[measure])

    def next(self) -> QuerySpec:
        rng = self.rng
        if self.cycle:
            t = self.templates[self.turn % len(self.templates)]
            self.turn += 1
        else:
            t = self.templates[int(rng.choice(len(self.templates), p=self.p))]
        ranges, eqs = [], []
        for p in t["predicates"]:
            col = p["column"]
            if col in self.num:
                if "start" in p:
                    start = float(rng.uniform(*p["start"]))
                    span = float(rng.uniform(*p["span"]))
                    ranges.append((self.num[col], start, start + span))
                else:
                    ranges.append((self.num[col], float(p["lo"]),
                                   float(p["hi"])))
            elif col in self.cat:
                dim = self.cat[col]
                value = (int(rng.integers(0, self.cat_size[dim]))
                         if p["eq"] == "uniform" else int(p["eq"]))
                eqs.append((dim, value))
            else:
                raise ValueError(f"column {col!r} is not in the schema")
        return QuerySpec(
            template=t["name"],
            aggs=tuple(self._agg(k, m) for k, m in t["aggs"]),
            ranges=tuple(ranges), eqs=tuple(eqs),
            groupby=tuple(self.cat[g] for g in t.get("groupby", ())))


class PoolStream:
    """Client ``k``'s share of a fixed pool: its queries ``start``,
    ``start + step``, ..., round the pool and again."""

    def __init__(self, pool, start: int, step: int):
        self.pool = pool
        self.i, self.step = int(start), int(step)

    def next(self) -> QuerySpec:
        q = self.pool[self.i % len(self.pool)]
        self.i += self.step
        return q


def _pool(mix, schema, kind: int, size: int):
    fixed = QueryStream(mix, schema, (int(mix["pool"]["seed"]), kind))
    return [fixed.next() for _ in range(size)]


def warmup_stream(mix: dict, schema: dict):
    return PoolStream(_pool(mix, schema, WARMUP_STREAM,
                            int(mix["warmup"]["queries"])), 0, 1)


def client_streams(mix: dict, schema: dict):
    """One stream for each of the mix's clients."""
    n = int(mix["clients"])
    pool = _pool(mix, schema, CLIENT_STREAM, int(mix["pool"]["size"]))
    return [PoolStream(pool, k, n) for k in range(n)]
