"""Synthetic relations and query workloads (paper §8.1 / §8.6).

- ``make_relation``: data whose measures follow a smooth random field over the
  numeric dimensions (random Fourier features ≈ a GP draw with a known SE
  lengthscale — giving non-zero inter-tuple covariance, Appendix E) plus
  per-category offsets and iid noise. Distribution families: uniform /
  gaussian / lognormal (Figure 6(b)).
- ``make_workload``: range/equality aggregate queries whose predicate columns
  follow the §8.6 power-law "frequently accessed columns" scheme.
- ``tpch_like``: a lineitem-flavoured star-schema fact table (denormalized) and
  templates mimicking the supported TPC-H aggregates (Q1/Q6-style).

Data is drawn with numpy exactly as the reference draws it, then placed on
``device`` (``None``: the CUDA card).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.aqp.queries import AggQuery, AggSpec, CatEq, NumRange
from repro_torch.aqp.relation import Relation
from repro_torch.core.types import Schema


def _smooth_field(rng, x_norm, lengthscale: float, n_features: int = 64):
    """Random Fourier features approximating a zero-mean SE-kernel GP draw."""
    l = x_norm.shape[1]
    omega = rng.normal(0.0, 1.0 / lengthscale, size=(n_features, l))
    phase = rng.uniform(0, 2 * np.pi, size=(n_features,))
    proj = x_norm @ omega.T + phase
    return np.sqrt(2.0 / n_features) * np.cos(proj).sum(axis=1) / np.sqrt(n_features) * n_features ** 0.5


def make_relation(
    seed: int,
    n_rows: int,
    n_num: int = 3,
    cat_sizes: Tuple[int, ...] = (8,),
    n_measures: int = 2,
    lengthscale: float = 0.3,
    noise: float = 0.3,
    distribution: str = "uniform",
    cat_effect: float = 0.5,
    device=None,
) -> Relation:
    rng = np.random.default_rng(seed)
    if distribution == "uniform":
        x = rng.uniform(0, 10, size=(n_rows, n_num))
    elif distribution == "gaussian":
        x = np.clip(rng.normal(5, 2, size=(n_rows, n_num)), 0, 10)
    elif distribution == "lognormal":
        x = np.clip(rng.lognormal(1.0, 0.6, size=(n_rows, n_num)), 0, 10)
    else:
        raise ValueError(distribution)
    if cat_sizes:
        cats = np.stack(
            [rng.integers(0, s, size=(n_rows,)) for s in cat_sizes], axis=1
        ).astype(np.int32)
    else:
        cats = np.zeros((n_rows, 0), np.int32)
    x_norm = x / 10.0
    measures = np.zeros((n_rows, n_measures))
    for m in range(n_measures):
        field = _smooth_field(rng, x_norm, lengthscale)
        if cat_sizes:
            offsets = rng.normal(0, cat_effect, size=(len(cat_sizes), max(cat_sizes)))
            cat_shift = sum(offsets[k, cats[:, k]] for k in range(len(cat_sizes)))
        else:
            cat_shift = 0.0
        measures[:, m] = 10.0 + 2.0 * field + cat_shift + rng.normal(0, noise, n_rows)
    schema = Schema(
        num_lo=tuple([0.0] * n_num),
        num_hi=tuple([10.0] * n_num),
        cat_sizes=tuple(cat_sizes),
        n_measures=n_measures,
        num_names=tuple(f"x{i}" for i in range(n_num)),
        cat_names=tuple(f"c{i}" for i in range(len(cat_sizes))),
        measure_names=tuple(f"v{i}" for i in range(n_measures)),
    )
    return Relation.from_columns(schema, x, cats, measures, device=device)


def power_law_probs(n_cols: int, frac_frequent: float) -> np.ndarray:
    """§8.6 column-access distribution: the first ``ceil(n_cols * frac)``
    "frequently accessed" columns are equally likely; every tail column is
    half as likely as its predecessor, starting from half the per-frequent-
    column mass.

    The halving chains off the head instead of a hardcoded ``0.5`` — with
    the all-ones head the old constant was numerically identical (so seeded
    workloads are unchanged), but it silently encoded the head mass; this
    form states the scheme structurally and is pinned by distribution tests.
    """
    k = max(int(np.ceil(n_cols * frac_frequent)), 1)
    probs = np.ones(n_cols)
    for i in range(k, n_cols):
        probs[i] = probs[i - 1] / 2.0
    return probs / probs.sum()


def _power_law_column(rng, n_cols: int, frac_frequent: float):
    """Draw one column index from the §8.6 power-law scheme."""
    return int(rng.choice(n_cols, p=power_law_probs(n_cols, frac_frequent)))


def make_workload(
    seed: int,
    schema: Schema,
    n_queries: int,
    *,
    n_predicates: Tuple[int, int] = (1, 3),
    frac_frequent: float = 1.0,
    width_range: Tuple[float, float] = (0.1, 0.5),
    agg_kinds: Tuple[str, ...] = ("AVG", "COUNT", "SUM"),
    cat_pred_prob: float = 0.3,
) -> List[AggQuery]:
    rng = np.random.default_rng(seed)
    queries = []
    for _ in range(n_queries):
        n_preds = rng.integers(n_predicates[0], n_predicates[1] + 1)
        preds = []
        used = set()
        for _ in range(n_preds):
            if schema.n_cat and rng.random() < cat_pred_prob:
                dim = _power_law_column(rng, schema.n_cat, frac_frequent)
                if ("c", dim) in used:
                    continue
                used.add(("c", dim))
                preds.append(CatEq(dim, int(rng.integers(0, schema.cat_sizes[dim]))))
            else:
                dim = _power_law_column(rng, schema.n_num, frac_frequent)
                if ("n", dim) in used:
                    continue
                used.add(("n", dim))
                span = schema.num_hi[dim] - schema.num_lo[dim]
                width = rng.uniform(*width_range) * span
                start = rng.uniform(schema.num_lo[dim], schema.num_hi[dim] - width)
                preds.append(NumRange(dim, start, start + width))
        kind = str(rng.choice(list(agg_kinds)))
        measure = int(rng.integers(0, schema.n_measures)) if kind != "COUNT" else None
        queries.append(AggQuery(aggs=(AggSpec(kind, measure),), predicates=tuple(preds)))
    return queries


# --------------------------------------------------------------------- TPC-H
def tpch_like(seed: int, n_rows: int = 200_000, device=None) -> Relation:
    """Denormalized lineitem-ish fact table with seasonal structure.

    numeric dims: ship_date (days), quantity, discount
    categorical:  returnflag(3), linestatus(2), nation(25)
    measures:     extendedprice, revenue = price*(1-discount)   (derived attr)
    """
    rng = np.random.default_rng(seed)
    date = rng.uniform(0, 2557, n_rows)  # 7 years of days
    qty = rng.uniform(1, 50, n_rows)
    disc = rng.uniform(0.0, 0.1, n_rows)
    rf = rng.integers(0, 3, n_rows)
    ls = rng.integers(0, 2, n_rows)
    nation = rng.integers(0, 25, n_rows)
    season = 1.0 + 0.3 * np.sin(2 * np.pi * date / 365.0) + 0.1 * (date / 2557.0)
    nation_mult = rng.uniform(0.7, 1.3, 25)
    price = (
        900.0 * season * nation_mult[nation] * (qty / 25.0)
        + rng.normal(0, 40.0, n_rows)
    )
    revenue = price * (1 - disc)
    schema = Schema(
        num_lo=(0.0, 1.0, 0.0),
        num_hi=(2557.0, 50.0, 0.1),
        cat_sizes=(3, 2, 25),
        n_measures=2,
        num_names=("ship_date", "quantity", "discount"),
        cat_names=("returnflag", "linestatus", "nation"),
        measure_names=("extendedprice", "revenue"),
    )
    num = np.stack([date, qty, disc], axis=1)
    cat = np.stack([rf, ls, nation], axis=1).astype(np.int32)
    meas = np.stack([price, revenue], axis=1)
    return Relation.from_columns(schema, num, cat, meas, device=device)


def tpch_workload(seed: int, schema: Schema, n_queries: int = 60) -> List[AggQuery]:
    """Q1/Q6-flavoured supported aggregates over the tpch_like relation."""
    rng = np.random.default_rng(seed)
    queries: List[AggQuery] = []
    for _ in range(n_queries):
        template = rng.integers(0, 3)
        start = rng.uniform(0, 2557 - 400)
        span = rng.uniform(90, 400)
        date_pred = NumRange(0, start, start + span)
        if template == 0:  # Q6-ish: revenue SUM in date+discount+qty window
            d0 = rng.uniform(0.0, 0.06)
            preds = (date_pred, NumRange(2, d0, d0 + 0.02), NumRange(1, 1, 24))
            queries.append(AggQuery(aggs=(AggSpec("SUM", 1),), predicates=preds))
        elif template == 1:  # Q1-ish: AVG price grouped by returnflag
            queries.append(
                AggQuery(
                    aggs=(AggSpec("AVG", 0), AggSpec("COUNT", None)),
                    predicates=(date_pred,),
                    groupby=(0,),
                )
            )
        else:  # nation revenue AVG
            queries.append(
                AggQuery(
                    aggs=(AggSpec("AVG", 1),),
                    predicates=(date_pred, CatEq(2, int(rng.integers(0, 25)))),
                )
            )
    return queries
