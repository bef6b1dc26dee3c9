"""Plain PyTorch version of the fused masked-scan kernel.

Takes the kernel's own inputs and computes the same function: the plain
scan's mask (``repro_torch.aqp.executor.snippet_mask``: ranges widened by
``RANGE_EPS``, categorical membership, validity) folded against the payload
``[measures, measures², 1]`` with the plain scan's fixed ascending-tile-order
fold (``masked_tile_fold``). So on the CPU it gives the same bits as
``repro_torch.aqp.executor.eval_partials``. The CPU path of the wrapper runs
it; on the card it is the yardstick the kernel is held to.

``masked_partials_ref`` is the plain version of K4, the aggregation-only
kernel of the sharded placement: the same fold over a mask built outside it.
"""
from __future__ import annotations

from repro_torch.aqp.executor import masked_tile_fold, payload_of, snippet_mask
from repro_torch.kernels import SCAN_TILE_T

__all__ = ["fused_masked_scan_ref", "masked_partials_ref"]


def fused_masked_scan_ref(x, codes, valid, measures, lo, hi, cat,
                          tile_t: int = SCAN_TILE_T):
    """x: (T,L) f64; codes: (T,C) int32; valid: (T,) f64 or None;
    measures: (T,M) f64; lo/hi: (Q,L) f64; cat: (Q,C,V) bool → (Q, 2M+1)."""
    mask = snippet_mask(x, codes, lo, hi, cat, valid)  # (T, Q)
    return masked_tile_fold(mask, payload_of(measures), tile_t)


def masked_partials_ref(mask, measures, tile_t: int = SCAN_TILE_T):
    """mask: (T,Q) f64; measures: (T,M) f64 → (Q, 2M+1): the mask folded
    against ``[measures, measures², 1]``."""
    return masked_tile_fold(mask, payload_of(measures), tile_t)
