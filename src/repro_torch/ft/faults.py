"""Deterministic, seeded fault injection at every seam of the serving stack.

The paper's Theorem 1 gives every failure of the learning plane a principled
degrade target: the improved answer is *in expectation* at least as accurate
as the plain sample estimate, so when any part of the synopsis machinery is
unhealthy the engine can always fall back to the raw AQP answer and keep the
error bound honest. This module is the test harness for that contract — a
registry of **named injection points** at the seams where real deployments
fail, plus a seeded plan that fires faults deterministically so chaos runs
are reproducible bit for bit.

Injection points (``POINTS``):

==================  =========================================================
``ingest.apply``    top of ``Synopsis._apply_add`` — a failed covariance
                    build / inverse update on the background ingest thread
                    (quarantines the synopsis; serving degrades to raw).
``scan.eval``       ``ScanPlacement.eval_block`` — a failed block eval /
                    kernel dispatch (the ``AqpService`` bisect-retry seam).
``store.drain``     ``Synopsis.drain`` — a failed ingest barrier, per shard
                    for ``ShardedSynopsisStore`` (quarantines the synopsis,
                    never the whole store).
``checkpoint.write``  ``CheckpointManager._write`` — a torn/failed shard
                    write (async failures surface on the next ``wait``).
``checkpoint.read``   ``CheckpointManager._read_step`` — a corrupt shard
                    read (restore falls back to an earlier intact step).
==================  =========================================================

Hot-path contract: ``fire(point)`` with no active plan is ONE module-global
load and an ``is None`` check — zero allocations, no locks, no dict lookups
— so the hooks can live on the serving hot path permanently (gated by the
``faults/hooks_inactive`` metric in ``benchmarks/check_regression.py``
alongside the scan/improve regression gates).

Determinism: every spec decides from its OWN counter (per ``(point, key)``)
— an explicit ``hits`` schedule and/or a seeded per-spec Bernoulli stream —
never from wall clock or global call order across keys, so a chaos run with
a fixed seed fires the same faults at the same call indices every time, even
with per-synopsis ingest threads interleaving arbitrarily (each synopsis'
apply order is FIFO, hence its per-key counter is deterministic).

Usage::

    from repro_torch.ft import faults

    with faults.inject(faults.FaultSpec("ingest.apply", key="agg0-measure0",
                                        hits=(1,)), seed=7):
        ...  # the 2nd apply on that synopsis raises InjectedFault

    faults.stats()  # {"ingest.apply": {"calls": 5, "fires": 1}, ...}
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

POINTS = (
    "ingest.apply",
    "scan.eval",
    "store.drain",
    "checkpoint.write",
    "checkpoint.read",
)


class InjectedFault(RuntimeError):
    """The typed failure every injection raises — callers can tell injected
    chaos from organic bugs, and the degraded-path telemetry carries the
    point name."""

    def __init__(self, point: str, key: Optional[str], hit: int):
        super().__init__(f"injected fault at {point}"
                         + (f"[{key}]" if key else "") + f" (hit {hit})")
        self.point = point
        self.key = key
        self.hit = hit


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed injection point.

    point:     a name from ``POINTS``.
    key:       optional key filter — ``None`` matches every call at the
               point; a string matches only calls fired with that key
               (e.g. a ``state_key`` like ``"agg0-measure0"``), which is
               what makes multi-threaded ingest chaos deterministic.
    hits:      explicit 0-based per-(point, key) call indices that fire.
    rate:      Bernoulli fire probability per call (seeded, per-spec
               stream; composes with ``hits``).
    max_fires: stop firing after this many (transient-fault modeling;
               ``None`` = unbounded).
    """

    point: str
    key: Optional[str] = None
    hits: Tuple[int, ...] = ()
    rate: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; known: {POINTS}")
        object.__setattr__(self, "hits", tuple(int(h) for h in self.hits))


class FaultPlan:
    """A seeded set of specs plus the mutable counters of one chaos run.

    The plan owns all bookkeeping so ``activate``/``deactivate`` swap whole
    runs atomically and ``stats()`` reads one object. Thread-safe: counters
    mutate under one lock (only reached when a plan is active).
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        # Per-spec seeded streams: independent of call interleaving across
        # specs, so one spec's draws never perturb another's.
        self._rngs = [
            np.random.default_rng((self.seed, i)) for i in range(len(specs))
        ]
        self._fires_per_spec = [0] * len(specs)
        self._counters: Dict[Tuple[str, Optional[str]], int] = {}
        self.calls: Dict[str, int] = {}
        self.fires: Dict[str, int] = {}

    def check(self, point: str, key: Optional[str]):
        """Count one call; raise ``InjectedFault`` if any spec fires."""
        with self._lock:
            self.calls[point] = self.calls.get(point, 0) + 1
            ck = (point, key)
            hit = self._counters.get(ck, 0)
            self._counters[ck] = hit + 1
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.key is not None and spec.key != key:
                    continue
                if (spec.max_fires is not None
                        and self._fires_per_spec[i] >= spec.max_fires):
                    continue
                fire = hit in spec.hits
                if not fire and spec.rate > 0.0:
                    fire = bool(self._rngs[i].random() < spec.rate)
                if fire:
                    self._fires_per_spec[i] += 1
                    self.fires[point] = self.fires.get(point, 0) + 1
                    raise InjectedFault(point, key, hit)


# The one module global the disabled fast path reads. ``None`` ⇔ inactive.
_PLAN: Optional[FaultPlan] = None


def fire(point: str, key: Optional[str] = None) -> None:
    """Injection hook — call at a seam; no-op unless a plan is active.

    The disabled path is intentionally the first two lines: one global load
    and an ``is None`` test, so leaving hooks on production seams costs
    nothing (see module docstring).
    """
    plan = _PLAN
    if plan is None:
        return
    plan.check(point, key)


def active() -> bool:
    """Whether a fault plan is currently armed."""
    return _PLAN is not None


def activate(plan: FaultPlan) -> FaultPlan:
    """Arm a plan (replacing any active one); returns it for chaining."""
    global _PLAN
    _PLAN = plan
    return plan


def deactivate() -> Optional[FaultPlan]:
    """Disarm; returns the plan that was active (its stats stay readable)."""
    global _PLAN
    plan, _PLAN = _PLAN, None
    return plan


@contextlib.contextmanager
def inject(*specs: FaultSpec, seed: int = 0):
    """Scoped chaos: arm a seeded plan for the ``with`` body, yield it."""
    plan = activate(FaultPlan(specs, seed=seed))
    try:
        yield plan
    finally:
        if _PLAN is plan:
            deactivate()


def stats() -> Dict[str, dict]:
    """Per-point ``{"calls": n, "fires": k}`` of the active plan (``{}``
    when disarmed — the shape ``Session.stats()["health"]`` surfaces)."""
    plan = _PLAN
    if plan is None:
        return {}
    with plan._lock:
        return {
            point: {"calls": plan.calls.get(point, 0),
                    "fires": plan.fires.get(point, 0)}
            for point in sorted(set(plan.calls) | set(plan.fires))
        }
