"""Plain PyTorch version of the group-discovery kernel.

Takes the kernel's own inputs and computes the same function: each probe's
admission of each tuple (``lo ≤ x ≤ hi`` on every numeric dim over bounds
the caller widened by ``RANGE_EPS``, AND categorical membership: the scan's
``snippet_mask`` test on the same doubles) and each tuple's mixed-radix
group code; then the table route's presence marks and the sorted route's
keys. The CPU path of the wrapper runs it; on the card it is the yardstick
the kernel is held to.
"""
from __future__ import annotations

import torch

__all__ = ["KEY_NONE", "group_discovery_ref"]

KEY_NONE = 2**63 - 1  # a sorted-route key of a tuple the probe does not admit


def group_discovery_ref(x, codes, lo, hi, member, gcol, gstride, route,
                        n_keys, n_rows):
    """x: (T,L) f64; codes: (T,C) int32 in [0, sizes); lo/hi: (P,L) f64,
    widened; member: (P,C,V) bool; gcol/gstride: (P,G) int64; route: (P,2)
    int64, (table offset, key space) or (-1, sorted row) → presence
    (n_keys,) uint8 and keys (n_rows, T) int64."""
    dev = x.device
    admit = ((x[:, None, :] >= lo[None]) & (x[:, None, :] <= hi[None])).all(-1)
    for k in range(codes.shape[1]):
        admit &= member[:, k, :].index_select(1, codes[:, k].long()).T
    code = (codes.long()[:, gcol] * gstride).sum(-1)  # (T, P)
    table = route[:, 0] >= 0
    presence = torch.zeros(n_keys, dtype=torch.uint8, device=dev)
    presence[(route[:, 0] + code)[admit & table]] = 1
    keys = torch.where(admit[:, ~table], code[:, ~table],
                       torch.tensor(KEY_NONE, device=dev))
    return presence, keys.T.contiguous().reshape(n_rows, x.shape[0])
