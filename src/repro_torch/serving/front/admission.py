"""Admission control for the multi-tenant serving front.

Token-bucket rate limiting plus a bounded microbatch queue, per tenant —
BlinkDB's "bounded response time" contract starts here: a tenant that
exceeds its budget gets a typed ``Rejection`` (never an exception, never an
unbounded queue), with a ``retry_after_s`` hint so well-behaved clients can
back off instead of hammering.

Determinism (analysis rule A008): this module never reads the wall clock
and never draws randomness. Every decision is a pure function of the
injected ``now`` timestamp and the controller's own state, so an admission
trace replays exactly from a recorded (or synthetic) clock — the replay
tests drive a fake clock through the same code paths production runs.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed admission refusal for ONE request (never an exception).

    Mirrors the answer ladder's ``failed`` discriminator so serving code
    can branch uniformly: ``QueryAnswer.failed`` is False,
    ``FailedAnswer.failed`` is True, and a ``Rejection`` is ``rejected``
    before it ever becomes an answer at all.
    """

    reason: str  # "rate_limit" | "queue_full"
    tenant: str
    retry_after_s: float
    detail: str = ""

    @property
    def rejected(self) -> bool:
        return True

    @property
    def failed(self) -> bool:
        return False

    @property
    def status(self) -> int:
        """The HTTP status the transport maps this to."""
        return 429 if self.reason == "rate_limit" else 503

    def __str__(self) -> str:
        return (f"Rejection({self.reason} for {self.tenant}; "
                f"retry after {self.retry_after_s:.3f}s)")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Per-tenant admission knobs.

    rate: token refill per second (sustained requests/sec); <= 0 disables
        rate limiting for the tenant.
    burst: bucket capacity — the instantaneous burst a cold tenant may
        spend before the sustained rate binds.
    max_pending: bound on the tenant's microbatch queue depth (submitted
        but not yet flushed); beyond it requests are rejected
        ``queue_full`` instead of growing the queue without bound.
    """

    rate: float = 50.0
    burst: int = 20
    max_pending: int = 256


class TokenBucket:
    """The classic token bucket, clock-free: callers supply ``now``.

    Fractional tokens accumulate continuously at ``rate`` per second up to
    ``burst``; ``try_take(now)`` spends one. Monotonic ``now`` values are
    the caller's contract (the front passes ``time.monotonic()``; replay
    tests pass a scripted sequence).
    """

    def __init__(self, rate: float, burst: int, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = float(now)

    def _refill(self, now: float):
        if now > self._stamp:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
        self._stamp = max(self._stamp, now)

    def try_take(self, now: float) -> bool:
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after(self, now: float) -> float:
        """Seconds until one full token exists (0 when one is available)."""
        self._refill(now)
        if self._tokens >= 1.0:
            return 0.0
        if self.rate <= 0.0:
            return float("inf")
        return (1.0 - self._tokens) / self.rate


class AdmissionController:
    """One tenant's admission gate: token bucket + queue-depth bound.

    ``admit(now, queue_depth)`` returns ``None`` (admitted) or a typed
    ``Rejection``. Thread-safe: concurrent request handlers for one tenant
    serialize on the controller's lock, so token accounting never races.
    """

    def __init__(self, tenant: str, config: Optional[AdmissionConfig] = None,
                 now: float = 0.0):
        self.tenant = tenant
        self.config = config or AdmissionConfig()
        self._bucket = (TokenBucket(self.config.rate, self.config.burst, now)
                        if self.config.rate > 0 else None)
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected_rate = 0
        self.rejected_queue = 0

    def admit(self, now: float, queue_depth: int) -> Optional[Rejection]:
        with self._lock:
            if queue_depth >= self.config.max_pending:
                self.rejected_queue += 1
                return Rejection(
                    "queue_full", self.tenant,
                    # The queue drains a whole microbatch per flush; one
                    # token period is the natural retry hint.
                    retry_after_s=(1.0 / self.config.rate
                                   if self.config.rate > 0 else 1.0),
                    detail=f"{queue_depth} pending >= "
                           f"max_pending={self.config.max_pending}")
            if self._bucket is not None and not self._bucket.try_take(now):
                self.rejected_rate += 1
                return Rejection(
                    "rate_limit", self.tenant,
                    retry_after_s=self._bucket.retry_after(now),
                    detail=f"sustained rate {self.config.rate}/s, "
                           f"burst {self.config.burst}")
            self.admitted += 1
            return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "rejected_rate_limit": self.rejected_rate,
                "rejected_queue_full": self.rejected_queue,
                "rate": self.config.rate,
                "burst": self.config.burst,
                "max_pending": self.config.max_pending,
            }
