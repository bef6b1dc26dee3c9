"""Deterministic, checkpointable, straggler-tolerant token pipeline.

A copy of the reference's ``repro.data.pipeline`` (pure numpy), so the
port gives its batches bit for bit without importing the JAX package.

- Determinism: batch ``step`` is a pure function of (seed, step, assignment),
  so any host can recompute any shard — restarts and elastic re-scales replay
  exactly (state is just the step counter, stored in every checkpoint).
- Over-decomposition (straggler mitigation): each global step is split into
  ``over_factor`` x more work units than hosts; units are claimed greedily so
  a slow host hands surplus units to fast ones. Within-SPMD compute stays
  bulk-synchronous; the stealing happens at the host/unit level (as in
  production input pipelines).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    over_factor: int = 4
    step: int = 0

    def unit_count(self) -> int:
        return self.n_hosts * self.over_factor

    def _unit_batch(self, step: int, unit: int) -> np.ndarray:
        per_unit = self.global_batch // self.unit_count()
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, unit]))
        toks = rng.integers(0, self.vocab,
                            size=(per_unit, self.seq_len + 1), dtype=np.int32)
        return toks

    def assignments(self, speeds: List[float] = None) -> List[List[int]]:
        """Greedy longest-processing-time unit assignment given host speeds
        (1.0 = nominal). Slow hosts get fewer units — work stealing."""
        speeds = speeds or [1.0] * self.n_hosts
        loads = [0.0] * self.n_hosts
        buckets: List[List[int]] = [[] for _ in range(self.n_hosts)]
        for unit in range(self.unit_count()):
            h = int(np.argmin([l + 1.0 / s for l, s in zip(loads, speeds)]))
            buckets[h].append(unit)
            loads[h] += 1.0 / speeds[h]
        return buckets

    def next_batch(self, speeds: List[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for this host's units at the current step."""
        buckets = self.assignments(speeds)
        units = buckets[self.host_id]
        toks = np.concatenate([self._unit_batch(self.step, u) for u in units])
        self.step += 1
        return toks[:, :-1], toks[:, 1:]

    def global_batch_at(self, step: int) -> np.ndarray:
        toks = np.concatenate(
            [self._unit_batch(step, u) for u in range(self.unit_count())])
        return toks

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s):
        self.step = int(s["step"])
        self.seed = int(s["seed"])
