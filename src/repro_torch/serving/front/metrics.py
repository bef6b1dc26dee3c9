"""Per-tenant serving observability: latency histograms + outcome counters.

Each tenant of the serving front gets one ``TenantMetrics`` block: log2-
bucketed latency histograms per operation (execute/explain/stream) and
counters over the full outcome ladder — answered, degraded (deadline or
quarantine), failed (typed ``FailedAnswer``), rejected (by admission
reason), prescreen hits. The front merges these with the admission and
workload-intel counters into ``ServingFront.stats()``.

Determinism (analysis rule A008): like ``admission``, this module never
reads a clock — latencies arrive as plain float durations measured by the
transport layer. Histogram bucketing is a pure function of the duration.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List


class LatencyHistogram:
    """Log2-bucketed latency histogram over (0, +inf) seconds.

    Bucket ``i`` covers ``[2**(i + LOW), 2**(i + LOW + 1))`` with ``LOW``
    = -20 (~1 microsecond); durations below the first bucket clamp into
    it, above the last into the last. 40 buckets span ~1us to ~17min.
    Quantiles interpolate within the winning bucket, which is exactly the
    fidelity a serving dashboard needs and cheap enough for the hot path.
    """

    LOW = -20
    N = 40

    def __init__(self):
        self.counts: List[int] = [0] * self.N
        self.total = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= 0.0:
            return 0
        i = int(math.floor(math.log2(seconds))) - self.LOW
        return min(max(i, 0), self.N - 1)

    def record(self, seconds: float):
        self.counts[self._bucket(seconds)] += 1
        self.total += 1
        self.sum_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def quantile(self, q: float) -> float:
        """Approximate quantile (bucket lower edge) in seconds."""
        if self.total == 0:
            return 0.0
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return 2.0 ** (i + self.LOW)
        return self.max_s

    def snapshot(self) -> dict:
        return {
            "count": self.total,
            "mean_s": self.sum_s / max(self.total, 1),
            "max_s": self.max_s,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
        }


class TenantMetrics:
    """One tenant's serving-outcome counters + per-op latency histograms.

    Outcomes partition every request: ``answered`` (full-accuracy),
    ``degraded`` (honest but weaker — deadline best-so-far or quarantined
    keys), ``failed`` (typed ``FailedAnswer``), ``rejected_*`` (admission
    turned it away before execution). ``prescreen_hits`` counts answers the
    workload-intel cache served at submit without a microbatch slot.
    """

    def __init__(self, tenant: str):
        self.tenant = tenant
        self._lock = threading.Lock()
        self.latency: Dict[str, LatencyHistogram] = {}
        self.answered = 0
        self.degraded = 0
        self.failed = 0
        self.rejected: Dict[str, int] = {}
        self.prescreen_hits = 0
        self.streams = 0
        self.stream_rounds = 0

    def record_outcome(self, answer, duration_s: float, op: str = "execute",
                       prescreened: bool = False):
        """Classify one resolved answer into the outcome ladder."""
        with self._lock:
            self.latency.setdefault(op, LatencyHistogram()).record(duration_s)
            if getattr(answer, "failed", False):
                self.failed += 1
            elif getattr(answer, "degraded", False):
                self.degraded += 1
            else:
                self.answered += 1
            if prescreened:
                self.prescreen_hits += 1

    def record_rejection(self, rejection):
        with self._lock:
            self.rejected[rejection.reason] = (
                self.rejected.get(rejection.reason, 0) + 1)

    def record_stream(self, rounds: int, duration_s: float):
        with self._lock:
            self.latency.setdefault(
                "stream", LatencyHistogram()).record(duration_s)
            self.streams += 1
            self.stream_rounds += rounds

    def snapshot(self) -> dict:
        with self._lock:
            executed = self.answered + self.degraded + self.failed
            rejected = sum(self.rejected.values())
            return {
                "tenant": self.tenant,
                "requests": executed + rejected,
                "answered": self.answered,
                "degraded": self.degraded,
                "failed": self.failed,
                "rejected": dict(self.rejected),
                "prescreen_hits": self.prescreen_hits,
                "prescreen_hit_rate": self.prescreen_hits / max(executed, 1),
                "streams": self.streams,
                "stream_rounds": self.stream_rounds,
                "latency": {op: h.snapshot()
                            for op, h in sorted(self.latency.items())},
            }
