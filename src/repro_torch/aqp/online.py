"""Online aggregation over sample batches (paper §7, deployment scenario 1).

Processes sample batches one at a time, maintaining accumulated partials and
emitting (raw theta, raw beta^2) after each batch. The engine wraps each
emission with model-based improvement and stops as soon as the *improved*
error meets the target.

A thin generator over ``repro_torch.aqp.plan.PhysicalPlan``: the same lazy
cumulative-partials scan every execution path uses; ``Session.stream`` adds
the improve/validate/record lifecycle on top.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

from repro_torch.aqp.executor import Partials
from repro_torch.aqp.plan import PhysicalPlan
from repro_torch.aqp.sampler import SampleBatches
from repro_torch.core.types import RawAnswer, SnippetBatch
from repro_torch.kernels.fused_masked_scan.ops import eval_partials_fused


@dataclasses.dataclass
class OnlineState:
    partials: Partials
    batches_used: int = 0


def online_answers(
    batches: SampleBatches,
    snippets: SnippetBatch,
    eval_fn: Optional[Callable] = None,
) -> Iterator[Tuple[RawAnswer, OnlineState]]:
    """Yields increasingly accurate raw answers after each sample batch.

    ``eval_fn(num_normalized, cat, measures, snippets)`` (default: the fused
    scan's wrapper, which launches its kernel on the card) is invoked on the
    TILE-PADDED snippet batch, placed on the sample's device; per-snippet
    partials are independent of padding, and the yielded answers and
    partials are sliced back to ``snippets.n``.
    """
    eval_fn = eval_fn or eval_partials_fused
    phys = PhysicalPlan(
        batches,
        snippets,
        lambda block, padded: eval_fn(
            block.num_normalized, block.cat, block.measures, padded
        ),
    )
    for b in range(batches.n_batches):
        raw = phys.raw_at(b)
        yield raw, OnlineState(phys.partials_at(b), b + 1)
