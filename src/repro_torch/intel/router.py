"""Learned per-query serve-path router (cache / improve / scan).

The cache is route "cache" and is decided by lookup; this module decides,
for queries that MUST execute, between the engine's two lifecycles:

- "improve": evaluate every sample batch round, improve + validate via the
  synopsis after each, early-stop once the improved bound meets the target
  (the engine's historical behavior under an error budget);
- "scan": skip the per-round improve/validate checks and evaluate the full
  batch budget in one final round (the engine's historical behavior without
  a target). Never violates the caller's budget — the full-budget answer is
  the most refined answer the engine can produce under it; what "scan"
  saves is per-round improve dispatches that were not going to stop early.

The choice is a deterministic cost model trained online from telemetry the
engine already emits — counters only: no wall-clock, no RNG anywhere in
route-feature derivation. Costs are in abstract "operand units":

    batch_cost   = tuples_per_batch × padded snippet count   (scan work)
    improve_cost = Σ_keys (q_bucket × fill_bucket² + fill_bucket²)
                                              (the GP serve matvec shapes)
    E[batches | fill bucket] = running mean of observed ``batches_used``
        of improve-routed targeted queries, bucketed by the largest fill
        bucket the query touches (optimistic 1.0 when unobserved, so the
        cold-start route is "improve" — exactly the pre-intel engine).

    route "improve"  iff  E[batches]×(batch_cost+improve_cost)
                          <= max_batches×batch_cost + improve_cost

A deterministic probe keeps the model honest: after ``probe_every``
consecutive "scan" decisions in one fill bucket, the next query routes
"improve" once so E[batches] keeps tracking a synopsis that got better.

The same observation stream drives the learned bucket-ladder floors: the
observed Q and fill distributions are histogrammed,
and every ``ladder_every`` observations the power-of-two bucket covering
the ``ladder_quantile`` of each distribution replaces the static
``EngineConfig(min_q_bucket=, min_fill_bucket=)`` floors — bitwise-safe
because padding rows are masked out of every product, so ladder moves change
tile shapes and cost, never answers.

Fill: every feature and observation reads a synopsis' fill as it will stand
once its own queued adds have applied (``Synopsis.queued_fill``, counted at
enqueue time; a quarantined synopsis counts as empty). That is the fill
``async_ingest=False`` reads, known without waiting for the ingest thread,
so routes replay alike under both ingest modes. (The JAX package reads
``Synopsis.n``, which under asynchronous ingest depends on how far the
ingest thread has got.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.store import group_rows
from repro_torch.core.types import SNIPPET_TILE, bucket_size


@dataclasses.dataclass
class RouterConfig:
    route_switching: bool = True  # False: always "improve" under a target
    probe_every: int = 16  # forced improve-probe cadence per fill bucket
    ladder_every: int = 32  # observations between ladder applications
    ladder_quantile: float = 0.9
    max_ladder_bucket: int = 512
    learn_ladder: bool = True


def _fill(syn) -> int:
    """A synopsis' fill once its queued adds have applied (0 if absent)."""
    return syn.queued_fill() if syn is not None else 0


def _fill_bucket(syn, fill: int) -> int:
    """The serve tile of that fill (0 for an empty or absent synopsis)."""
    return (bucket_size(fill, syn.min_fill_bucket, cap=syn.capacity)
            if fill else 0)


class ServeRouter:
    """Online route chooser + ladder learner (see module docstring)."""

    def __init__(self, config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        # fill bucket -> [count, sum of batches_used] (improve-routed only)
        self._batches: Dict[int, list] = {}
        self._scan_streak: Dict[int, int] = {}
        # histograms for the learned ladder: value -> count
        self._q_hist: Dict[int, int] = {}
        self._fill_hist: Dict[int, int] = {}
        self.observations = 0
        self.learned_floors: Optional[Tuple[int, int]] = None  # (q, fill)

    # ------------------------------------------------------------ features
    @staticmethod
    def _features(engine, lp) -> Tuple[int, float, float]:
        """(max fill bucket, batch_cost, improve_cost) — all deterministic
        functions of plan + store occupancy."""
        tuples_per_batch = (
            sum(len(b) for b in engine.batches.batch_rows)
            / max(engine.batches.n_batches, 1)
        )
        n_pad = -(-lp.plan.snippets.n // SNIPPET_TILE) * SNIPPET_TILE
        batch_cost = tuples_per_batch * n_pad
        improve_cost = 0.0
        fill_bucket = 0
        for key, rows in group_rows(lp.plan.snippets):
            syn = engine.store.get(key)
            fb = _fill_bucket(syn, _fill(syn))
            qb = bucket_size(len(rows), engine.config.min_q_bucket)
            improve_cost += qb * fb * fb + fb * fb
            fill_bucket = max(fill_bucket, fb)
        return fill_bucket, batch_cost, improve_cost

    def _expected_batches(self, fill_bucket: int) -> float:
        stat = self._batches.get(fill_bucket)
        if not stat or not stat[0]:
            return 1.0  # optimistic: cold-start route is "improve"
        return stat[1] / stat[0]

    def predict_route(self, engine, lp, target: Optional[float],
                      max_batches: int) -> str:
        """Pure route prediction (no probe-streak mutation) — explain()."""
        if target is None:
            return "scan"
        if not self.config.route_switching or lp.plan is None:
            return "improve"
        fb, batch_cost, improve_cost = self._features(engine, lp)
        if fb == 0:
            return "improve"  # empty synopses: improve rounds are no-ops
        est = self._expected_batches(fb)
        improve_total = est * (batch_cost + improve_cost)
        scan_total = max_batches * batch_cost + improve_cost
        return "improve" if improve_total <= scan_total else "scan"

    def choose_route(self, engine, lp, target: Optional[float],
                     max_batches: int) -> str:
        route = self.predict_route(engine, lp, target, max_batches)
        if target is None or lp.plan is None:
            return route
        fb, _, _ = self._features(engine, lp)
        if route == "scan":
            streak = self._scan_streak.get(fb, 0) + 1
            if streak >= self.config.probe_every:
                # Deterministic exploration: periodically re-measure how
                # many batches the improve path actually needs now.
                route, streak = "improve", 0
            self._scan_streak[fb] = streak
        else:
            self._scan_streak[fb] = 0
        return route

    # ------------------------------------------------------------- observe
    def observe(self, engine, lp, res, target: Optional[float], route: str):
        if lp.plan is None:
            return
        fill_bucket = 0
        for key, rows in group_rows(lp.plan.snippets):
            q = len(rows)
            self._q_hist[q] = self._q_hist.get(q, 0) + 1
            syn = engine.store.get(key)
            n = _fill(syn)
            self._fill_hist[n] = self._fill_hist.get(n, 0) + 1
            fb = _fill_bucket(syn, n)
            fill_bucket = max(fill_bucket, fb)
        if target is not None and route == "improve":
            stat = self._batches.setdefault(fill_bucket, [0, 0.0])
            stat[0] += 1
            stat[1] += float(res.batches_used)
        self.observations += 1
        if (self.config.learn_ladder
                and self.observations % self.config.ladder_every == 0):
            self.apply_ladder(engine)

    # -------------------------------------------------------------- ladder
    @staticmethod
    def _quantile(hist: Dict[int, int], q: float) -> int:
        total = sum(hist.values())
        if total == 0:
            return 0
        need = q * total
        seen = 0
        for value in sorted(hist):
            seen += hist[value]
            if seen >= need:
                return value
        return max(hist)

    def ladder(self) -> Tuple[int, int]:
        """Learned (min_q_bucket, min_fill_bucket) floors: the power-of-two
        bucket covering ``ladder_quantile`` of the observed distributions,
        clamped to [engine default minimum, max_ladder_bucket]."""
        cfg = self.config
        q90 = self._quantile(self._q_hist, cfg.ladder_quantile)
        f90 = self._quantile(self._fill_hist, cfg.ladder_quantile)
        cap = cfg.max_ladder_bucket
        return (min(bucket_size(q90), cap), min(bucket_size(f90), cap))

    def apply_ladder(self, engine):
        """Install the learned floors on the engine config (new synopses)
        and every live synopsis (serve-path tiles). Padding invariance
        makes this answer-preserving — only compiled bucket shapes move."""
        qf, ff = self.ladder()
        self.learned_floors = (qf, ff)
        engine.config.min_q_bucket = qf
        engine.config.min_fill_bucket = min(ff, engine.config.capacity)
        for key in list(engine.store.keys()):
            syn = engine.store.get(key)
            if syn is None:
                continue
            syn.min_q_bucket = qf
            syn.min_fill_bucket = min(ff, syn.capacity)

    # -------------------------------------------------------------- persist
    def state_dict(self) -> dict:
        return {
            "batches": {str(k): [int(v[0]), float(v[1])]
                        for k, v in self._batches.items()},
            "scan_streak": {str(k): int(v)
                            for k, v in self._scan_streak.items()},
            "q_hist": {str(k): int(v) for k, v in self._q_hist.items()},
            "fill_hist": {str(k): int(v) for k, v in self._fill_hist.items()},
            "observations": int(self.observations),
            "learned_floors": (list(self.learned_floors)
                               if self.learned_floors else None),
        }

    def load_state_dict(self, state: dict):
        self._batches = {int(k): [int(v[0]), float(v[1])]
                         for k, v in dict(state.get("batches", {})).items()}
        self._scan_streak = {
            int(k): int(v)
            for k, v in dict(state.get("scan_streak", {})).items()}
        self._q_hist = {int(k): int(v)
                        for k, v in dict(state.get("q_hist", {})).items()}
        self._fill_hist = {
            int(k): int(v)
            for k, v in dict(state.get("fill_hist", {})).items()}
        self.observations = int(state.get("observations", 0))
        lf = state.get("learned_floors")
        self.learned_floors = tuple(int(v) for v in lf) if lf else None

    def stats(self) -> dict:
        return {
            "observations": self.observations,
            "expected_batches": {
                fb: round(self._expected_batches(fb), 3)
                for fb in sorted(self._batches)},
            "learned_floors": self.learned_floors,
        }
