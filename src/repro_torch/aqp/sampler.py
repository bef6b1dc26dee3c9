"""Offline sample creation and online-aggregation batch streams (paper §8.1).

NoLearn-style: a uniform random sample of the fact relation is built offline,
split into batches of tuples; online aggregation refines answers batch by
batch. Rows are drawn with numpy ``default_rng`` exactly as the reference
draws them, so the sample rows and batch order match it bit for bit; the
sample itself lives on the relation's device.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.aqp.relation import Relation


@dataclasses.dataclass
class SampleBatches:
    relation: Relation  # the sample, permuted
    batch_rows: List[np.ndarray]
    source_cardinality: int

    @property
    def n_batches(self) -> int:
        return len(self.batch_rows)


def build_sample(
    relation: Relation,
    rate: float = 0.1,
    n_batches: int = 10,
    seed: int = 0,
) -> SampleBatches:
    rng = np.random.default_rng(seed)
    n = relation.cardinality
    k = max(int(round(n * rate)), 1)
    rows = rng.choice(n, size=k, replace=False)
    sample = relation.take(rows)
    order = rng.permutation(k)
    batch_rows = [order[i::n_batches] for i in range(n_batches)]
    batch_rows = [b for b in batch_rows if len(b)]
    return SampleBatches(sample, batch_rows, source_cardinality=n)
