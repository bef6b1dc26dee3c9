"""Typed answers and reports for the public Session API.

``Cell``/``QueryAnswer`` replace the engine-level ``List[dict]`` cells with
frozen dataclasses; ``Cell.to_dict``/``from_dict`` round-trip bit-for-bit to
the engine representation, so facade answers can always be checked against
the engine's bitwise-parity oracle. ``PlanReport`` is ``Session.explain``'s
output: the plan the engine would run, including where each aggregate key's
learned state is placed (``SynopsisStore`` shard assignments).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.utils.stats import confidence_multiplier


@dataclasses.dataclass(frozen=True)
class Cell:
    """One output cell of an aggregate query.

    group:    the group-by value tuple (empty when no group-by)
    agg:      index of the aggregate within the query's select list
    kind:     'AVG' | 'SUM' | 'COUNT'
    estimate: the (possibly model-improved) answer
    beta2:    its variance; ``error_bound(delta)`` is the ±bound at
              confidence ``delta``
    """

    group: Tuple[int, ...]
    agg: int
    kind: str
    estimate: float
    beta2: float

    def error_bound(self, delta: float = 0.95) -> float:
        return float(confidence_multiplier(delta)) * float(np.sqrt(self.beta2))

    def rel_error(self, delta: float = 0.95) -> float:
        return self.error_bound(delta) / max(abs(self.estimate), 1e-9)

    def to_dict(self) -> dict:
        """The engine-level dict representation (bitwise round-trip)."""
        return {
            "group": self.group,
            "agg": self.agg,
            "kind": self.kind,
            "estimate": self.estimate,
            "beta2": self.beta2,
        }

    @staticmethod
    def from_dict(d: dict) -> "Cell":
        return Cell(
            group=tuple(d["group"]),
            agg=int(d["agg"]),
            kind=str(d["kind"]),
            estimate=d["estimate"],
            beta2=d["beta2"],
        )


@dataclasses.dataclass(frozen=True)
class QueryAnswer:
    """Typed result of one query through the Session facade.

    ``final`` is False only for the intermediate refinements yielded by
    ``Session.stream``. ``truncated_groups`` surfaces group-by cells dropped
    by the planner's ``n_max`` cap (see ``SnippetPlan.truncated_groups``).

    ``degraded``/``degraded_reasons``: the answer is honest but weaker than
    a healthy engine would serve — quarantined synopses left their groups
    on the raw sample estimate (Theorem 1's floor), or a deadline returned
    the best-so-far answer with its wider CI. Reasons are
    ``{state_key | "deadline": description}``.

    ``served_from``: ``"cache:exact"``/``"cache:subsumed"`` when the
    workload-intelligence plane answered without scanning
    (``repro_torch.intel``); None for every executed answer.
    """

    cells: Tuple[Cell, ...]
    batches_used: int
    tuples_scanned: int
    supported: bool
    unsupported_reason: Optional[str] = None
    truncated_groups: int = 0
    final: bool = True
    degraded: bool = False
    degraded_reasons: dict = dataclasses.field(default_factory=dict)
    served_from: Optional[str] = None

    @property
    def failed(self) -> bool:
        """Degradation-ladder bottom check: a ``QueryAnswer`` always carries
        a valid estimate (``FailedAnswer.failed`` is True)."""
        return False

    @staticmethod
    def from_result(result, final: bool = True) -> "QueryAnswer":
        """Lift an engine ``QueryResult`` into the typed representation."""
        return QueryAnswer(
            cells=tuple(Cell.from_dict(c) for c in result.cells),
            batches_used=result.batches_used,
            tuples_scanned=result.tuples_scanned,
            supported=result.supported,
            unsupported_reason=result.unsupported_reason,
            truncated_groups=result.truncated_groups,
            final=final,
            degraded=bool(getattr(result, "degraded", False)),
            degraded_reasons=dict(getattr(result, "degraded_reasons", {})),
            served_from=getattr(result, "served_from", None),
        )

    def max_rel_error(self, delta: float = 0.95) -> float:
        return max((c.rel_error(delta) for c in self.cells), default=0.0)

    @property
    def value(self) -> float:
        """Single-cell convenience: the lone estimate."""
        if len(self.cells) != 1:
            raise ValueError(
                f"answer has {len(self.cells)} cells; use .cells directly"
            )
        return self.cells[0].estimate


@dataclasses.dataclass(frozen=True)
class FailedAnswer:
    """Typed terminal failure for ONE query — the bottom rung of the
    degradation ladder (improved → raw-sample → ``FailedAnswer``).

    ``AqpService.flush`` resolves a poison query's ticket with this after
    bisect isolation and bounded retries exhaust: the query failed, but it
    failed ALONE (the rest of its microbatch answered normally) and it
    failed LOUDLY (a typed value, never a hung ticket or a silent None).
    Mirrors ``QueryAnswer``'s shape loosely (``cells``/``failed``/``final``)
    so serving code can branch on ``answer.failed`` uniformly.
    """

    error: str  # repr of the terminal exception
    error_type: str  # exception class name (e.g. "InjectedFault")
    attempts: int  # execution attempts spent before giving up
    final: bool = True
    cells: Tuple = ()

    @property
    def failed(self) -> bool:
        return True

    def __str__(self) -> str:
        return (f"FailedAnswer({self.error_type} after {self.attempts} "
                f"attempt{'s' if self.attempts != 1 else ''}: {self.error})")


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """What ``Session.explain`` saw: the plan without running the scan.

    ``q_buckets``/``fill_buckets``: predicted power-of-two serve tiles per
    aggregate-function key ``(agg, measure)`` — the (Q-bucket, fill-bucket)
    program the improve dispatch would compile/reuse. ``dedup_ratio`` is the
    within-query snippet reuse (shared FREQ rows across SUM/COUNT cells).
    ``placement``: per aggregate-function key, where the ``SynopsisStore``
    puts (or would put) its learned state — ``"local"`` for the default
    store, ``"shard<i>:<device>"`` under per-key mesh placement.
    ``scan_placement``: the scan plane's ``ScanPlacement`` (``"local"`` or
    ``"sharded:<n>x<axis>"``) — with a mesh, blocks pad/mask to shard over
    any relation size, and reported scanned-tuple counts stay true counts.
    ``scan_evaluator``: the per-block evaluator the placement WILL route
    through — ``"oracle"`` (the plain scan, on the CPU),
    ``"fused_masked_scan"`` (the fused scan kernel, on the card), or under a
    mesh ``"sharded_mask+kernel_agg"`` (per-shard mask build + the
    ``masked_partials`` kernel, on the card) / ``"sharded_mask+oracle_agg"``
    (the same with the plain fold, on the CPU).
    """

    supported: bool
    unsupported_reason: Optional[str]
    n_cells: int
    n_groups: int
    truncated_groups: int
    n_snippets: int
    n_snippets_unique: int
    dedup_ratio: float
    q_buckets: dict
    fill_buckets: dict
    placement: dict = dataclasses.field(default_factory=dict)
    scan_placement: str = "local"
    scan_evaluator: str = "oracle"
    # state_key -> quarantine reason for every currently-quarantined
    # synopsis this query's keys would touch: the query WILL serve, but its
    # affected groups stay on the raw sample estimate until heal().
    quarantined: dict = dataclasses.field(default_factory=dict)
    # Workload intelligence (None when no intel plane is attached):
    # ``cache`` is the answer-cache status this query would see RIGHT NOW
    # ("exact" | "subsumed" | "miss" | "uncacheable"), ``route`` the serve
    # path the router would pick ("cache" | "improve" | "scan").
    cache: Optional[str] = None
    route: Optional[str] = None

    def __str__(self) -> str:
        head = ("supported" if self.supported
                else f"raw-only ({self.unsupported_reason})")
        lines = [
            f"plan: {head}",
            f"  scan={self.scan_placement} evaluator={self.scan_evaluator}",
            f"  cells={self.n_cells} groups={self.n_groups}"
            f" truncated_groups={self.truncated_groups}",
            f"  snippets={self.n_snippets} unique={self.n_snippets_unique}"
            f" dedup={self.dedup_ratio:.2f}x",
        ]
        if self.cache is not None:
            lines.append(
                f"  served from cache: {self.cache} → route={self.route}"
            )
        for key in sorted(self.q_buckets):
            where = self.placement.get(key, "local")
            lines.append(
                f"  agg_key={key}: Q-bucket={self.q_buckets[key]}"
                f" fill-bucket={self.fill_buckets[key]}"
                f" placement={where}"
            )
        for name, reason in sorted(self.quarantined.items()):
            lines.append(
                f"  QUARANTINED {name}: serving raw sample estimates"
                f" ({reason})"
            )
        return "\n".join(lines)
