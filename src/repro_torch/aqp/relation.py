"""Columnar relation store, resident on one device.

A (denormalized) relation r with l numeric dimension attributes, c categorical
dimension attributes and m measure attributes (paper §3.1). Numeric dimensions
are additionally stored domain-normalized to [0, 1] — the same units snippets,
lengthscales and the scan kernel use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import F64, Schema, resolve_device


@dataclasses.dataclass
class Relation:
    schema: Schema
    num: torch.Tensor  # (N, l) raw units, f64
    cat: torch.Tensor  # (N, c) int32 codes
    measures: torch.Tensor  # (N, m) f64
    num_normalized: torch.Tensor = None  # (N, l) in [0,1]

    def __post_init__(self):
        if self.num_normalized is None:
            dev = self.num.device
            lo = torch.tensor(self.schema.num_lo, dtype=F64, device=dev)
            hi = torch.tensor(self.schema.num_hi, dtype=F64, device=dev)
            self.num_normalized = ((self.num - lo)
                                   / torch.clamp(hi - lo, min=1e-300))

    @property
    def device(self) -> torch.device:
        return self.num.device

    @property
    def cardinality(self) -> int:
        return int(self.num.shape[0])

    def take(self, rows) -> "Relation":
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return Relation(
            schema=self.schema,
            num=self.num.index_select(0, idx),
            cat=self.cat.index_select(0, idx),
            measures=self.measures.index_select(0, idx),
            num_normalized=self.num_normalized.index_select(0, idx),
        )

    @staticmethod
    def from_columns(schema: Schema, num, cat, measures,
                     device=None) -> "Relation":
        """Columns (numpy or tensors) → a relation on ``device``
        (``None``: the CUDA card)."""
        dev = resolve_device(device)
        return Relation(
            schema=schema,
            num=torch.as_tensor(np.asarray(num, np.float64), device=dev),
            cat=torch.as_tensor(np.asarray(cat, np.int32), device=dev),
            measures=torch.as_tensor(np.asarray(measures, np.float64),
                                     device=dev),
        )

    def exact_answer(self, snippets, chunk: int = 1 << 19):
        """Ground-truth answers for a SnippetBatch (testing/benchmarks only).

        Plain PyTorch on the relation's device, never the scan kernel, so
        that the truth a kernel's answers are checked against does not
        come from that kernel: the mask of ``chunk`` rows at a time, folded
        into ``[measures, measures², 1]`` by one matrix product each.
        """
        from repro_torch.aqp.executor import (
            Partials, estimates_from_partials, partials_from_columns,
            payload_of, snippet_mask)

        snippets = snippets.to(self.device)
        out = 0.0
        for s in range(0, self.cardinality, chunk):
            rows = slice(s, s + chunk)
            mask = snippet_mask(self.num_normalized[rows], self.cat[rows],
                                snippets.lo, snippets.hi, snippets.cat)
            out = out + mask.T @ payload_of(self.measures[rows])
        scanned = torch.tensor(float(self.cardinality), dtype=F64,
                               device=self.device)
        parts: Partials = partials_from_columns(
            out, snippets, self.measures.shape[1], scanned)
        theta, _, _ = estimates_from_partials(parts, snippets, exact=True)
        return theta
