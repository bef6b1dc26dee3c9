"""Plain PyTorch version of the range-mask aggregation kernel, in float32.

``out[q, p] = Σ_t [lo[q] − ε ≤ x[t] ≤ hi[q] + ε on every dim] · extra[t, q]
· payload[t, p]``, with x, lo, hi and the widened bounds in float32 (as the
reference kernel compares) and the scan plane's fixed ascending-tile fold
(``masked_tile_fold``) in float32. The CPU path of the wrapper runs it; on
the card it is the yardstick the kernel is held to.
"""
from __future__ import annotations

import torch

from repro_torch.aqp.executor import masked_tile_fold
from repro_torch.kernels import RANGE_EPS

__all__ = ["range_mask_agg_ref"]

F32 = torch.float32


def range_mask_agg_ref(x, payload, lo, hi, extra_mask=None):
    """x: (T,L); payload: (T,P); lo/hi: (Q,L); extra_mask: (T,Q) or None
    → (Q,P) float32."""
    x, payload, lo, hi = (v.to(F32) for v in (x, payload, lo, hi))
    eps = torch.tensor(RANGE_EPS, dtype=F32, device=x.device)
    mask = ((x[:, None, :] >= (lo - eps)[None])
            & (x[:, None, :] <= (hi + eps)[None])).all(-1).to(F32)
    if extra_mask is not None:
        mask = mask * extra_mask.to(F32)
    return masked_tile_fold(mask, payload)
