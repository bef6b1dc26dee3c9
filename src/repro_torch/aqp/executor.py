"""Snippet evaluation over tuple blocks + CLT error bounds (local placement).

The plain form of a multi-snippet scan builds a (tuples × snippets)
predicate mask and folds it against ``[measures, measures², 1]``. That plain
form lives here (``predicate_mask``, ``masked_tile_fold``, ``eval_partials``)
and is what the CPU runs; on the CUDA card every scan goes through the
``fused_masked_scan`` kernel wrapper
(``repro_torch.kernels.fused_masked_scan.ops.eval_partials_fused``), which
never writes the mask to memory. ``predicate_mask`` also serves group-by
discovery, which the reference computes outside any kernel too.

``masked_tile_fold`` is the canonical reduction of the plain scan: fixed
(SCAN_TILE_T × SCAN_TILE_Q) tiles folded in ascending tuple-tile order. Its
fixed-shape tile products make each snippet's partials bitwise independent
of how many snippets ride along (Q-padding) on a given backend.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import AVG, F64, SnippetBatch
from repro_torch.ft import faults
from repro_torch.kernels import RANGE_EPS, SCAN_TILE_Q, SCAN_TILE_T

BIG_BETA2 = 1e12  # raw error for snippets with no support in the scanned sample


@dataclasses.dataclass(frozen=True)
class Partials:
    """Sufficient statistics accumulated over scanned tuples."""

    sums: torch.Tensor  # (n,) sum of measure over matching tuples
    sumsq: torch.Tensor  # (n,)
    count: torch.Tensor  # (n,) matching tuples
    scanned: torch.Tensor  # () total VALID tuples scanned (mask sum)

    def __add__(self, other: "Partials") -> "Partials":
        return Partials(
            self.sums + other.sums,
            self.sumsq + other.sumsq,
            self.count + other.count,
            self.scanned + other.scanned,
        )


def snippet_mask(x, codes, lo, hi, cat, valid=None):
    """(T, n) float64 mask: ``lo − RANGE_EPS ≤ x ≤ hi + RANGE_EPS`` on every
    numeric dim, AND categorical membership, times ``valid``.

    x: (T, l) normalized units; codes: (T, c) int; lo/hi: (n, l);
    cat: (n, c, V) bool; valid: optional (T,) 0/1 — invalid (padding) rows
    are forced to exactly 0.0 in every column.
    """
    mask = ((x[:, None, :] >= lo[None, :, :] - RANGE_EPS)
            & (x[:, None, :] <= hi[None, :, :] + RANGE_EPS)).all(-1)
    c = codes.shape[1] if codes.dim() == 2 else 0
    for k in range(c):
        # cat[:, k, :]: (n, V); codes[:, k]: (T,)
        mk = cat[:, k, :].index_select(1, codes[:, k].long())  # (n, T)
        mask = mask & mk.T
    mask = mask.to(F64)
    if valid is not None:
        mask = mask * valid[:, None]
    return mask


def predicate_mask(num_normalized, cat, snippets: SnippetBatch, valid=None):
    """(T, n) float64 mask of tuples satisfying each snippet's predicates."""
    return snippet_mask(num_normalized, cat, snippets.lo, snippets.hi,
                        snippets.cat, valid)


def masked_tile_fold(mask, payload, tile_t: int = SCAN_TILE_T,
                     tile_q: int = SCAN_TILE_Q):
    """out[q, p] = sum_t mask[t, q] * payload[t, p], folded per snippet tile
    over fixed (tile_t, tile_q) tiles in ascending tuple-tile order.

    Zero-pads both axes to tile multiples; padding contributes exact zeros
    and is sliced away. Every tile product has the same fixed shape, so a
    snippet's partials do not depend on how many snippets ride along.
    """
    t, q = mask.shape
    p = payload.shape[1]
    pad_t = (-t) % tile_t
    pad_q = (-q) % tile_q
    if pad_t:
        mask = torch.cat([mask, mask.new_zeros((pad_t, q))])
        payload = torch.cat([payload, payload.new_zeros((pad_t, p))])
    if pad_q:
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], pad_q))], 1)
    cols = []
    for j in range(mask.shape[1] // tile_q):
        sq = slice(j * tile_q, (j + 1) * tile_q)
        acc = None
        for i in range(mask.shape[0] // tile_t):
            st = slice(i * tile_t, (i + 1) * tile_t)
            part = mask[st, sq].T @ payload[st]
            acc = part if acc is None else acc + part
        if acc is None:  # zero-row block
            acc = payload.new_zeros((tile_q, p))
        cols.append(acc)
    out = torch.cat(cols) if cols else payload.new_zeros((0, p))
    return out[:q]


def payload_of(measures):
    """The scan payload ``[measures, measures², 1]``: (T, 2m+1)."""
    t = measures.shape[0]
    return torch.cat([measures, measures * measures,
                      measures.new_ones((t, 1))], 1)


def partials_from_columns(out, snippets: SnippetBatch, m: int,
                          scanned) -> Partials:
    """(n, 2m+1) accumulated columns → ``Partials``: gather each snippet's own
    measure's sum and sum of squares; the last column is the count."""
    idx = snippets.measure.long()[:, None]
    sums = out[:, :m].gather(1, idx)[:, 0]
    sumsq = out[:, m:2 * m].gather(1, idx)[:, 0]
    return Partials(sums, sumsq, out[:, 2 * m], scanned)


def _partials_from_mask(mask, measures, snippets: SnippetBatch,
                        scanned) -> Partials:
    """The mask → sufficient-statistics aggregation of the plain scan."""
    out = masked_tile_fold(mask, payload_of(measures))  # (n, 2m+1)
    return partials_from_columns(out, snippets, measures.shape[1], scanned)


def eval_partials(num_normalized, cat, measures, snippets: SnippetBatch,
                  valid=None) -> Partials:
    """Partial statistics for one tuple block — the plain PyTorch scan.

    ``valid``: optional (T,) validity mask for zero-padded tuple blocks.
    Padding rows contribute exactly nothing, and ``scanned`` is the mask
    sum — the true number of tuples scanned, not the padded shape.
    """
    mask = predicate_mask(num_normalized, cat, snippets, valid)  # (T, n)
    scanned = (torch.tensor(float(num_normalized.shape[0]), dtype=F64,
                            device=num_normalized.device)
               if valid is None else valid.sum())
    return _partials_from_mask(mask, measures, snippets, scanned)


class ScanPlacement:
    """Placement seam of the scan plane (local placement).

    Owns HOW a block is evaluated; the query lifecycle only ever calls
    ``eval_block``, which goes through the ``fused_masked_scan`` wrapper:
    the CUDA kernel for blocks on the card, its plain version for blocks on
    the CPU.
    """

    def eval_block(self, block, snippets: SnippetBatch) -> Partials:
        """Partials for one tuple block through this placement."""
        from repro_torch.kernels.fused_masked_scan.ops import (
            eval_partials_fused)

        faults.fire("scan.eval")  # seam: before dispatch, state untouched
        return eval_partials_fused(block.num_normalized, block.cat,
                                   block.measures, snippets)


def estimates_from_partials(parts: Partials, snippets: SnippetBatch,
                            exact: bool = False):
    """CLT raw answers (theta_i, beta_i^2) from accumulated partials.

    FREQ: p_hat = count/scanned, beta^2 = p(1-p)/scanned.
    AVG:  x_bar = sum/count,     beta^2 = sample_var/count.
    ``exact=True`` zeroes the errors (used for ground-truth evaluation).
    """
    scanned = torch.clamp(parts.scanned, min=1.0)
    cnt = parts.count
    p_hat = cnt / scanned
    freq_beta2 = p_hat * (1.0 - p_hat) / scanned

    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = parts.sums / safe_cnt
    var = torch.clamp(parts.sumsq / safe_cnt - mean * mean, min=0.0)
    avg_beta2 = var / safe_cnt

    is_avg = snippets.agg == AVG
    theta = torch.where(is_avg, mean, p_hat)
    beta2 = torch.where(is_avg, avg_beta2, freq_beta2)
    no_support = is_avg & (cnt < 2)
    theta = torch.where(no_support, torch.zeros_like(theta), theta)
    beta2 = torch.where(no_support, torch.full_like(beta2, BIG_BETA2), beta2)
    if exact:
        beta2 = torch.zeros_like(beta2)
    return theta, beta2, ~no_support
