"""Public wrapper of the group-discovery kernel.

``group_discovery`` takes the kernel's own inputs and returns each probe's
marks over the tuples: on a CUDA tensor it launches
``csrc/group_discovery.cu`` (one launch for every probe), on a CPU tensor
it runs the plain version (``ref.group_discovery_ref``). Anything else
raises. ``distinct_keys`` finishes the sorted route on the same device.

Routes, by key space (the product of a probe's group-by sizes), a shape the
code observes: probes take the table route, in order, while their tables
fit ``GD_TABLE_KEYS`` keys together (a byte a key, held in a block's
shared memory; the host receives the table); a probe whose table would not
fit takes the sorted route (the kernel writes each tuple's code, the card
sorts and keeps the distinct ones; the host receives those).
``discovery_plan`` lays the routes out from the group-by columns alone.
The engine (``VerdictEngine._discover_groups_many``) copies the marks to
the host and decodes them into group tuples.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import F64
from repro_torch.kernels import (
    check_cuda_error,
    check_tensor,
    count_launch,
    load,
)
from repro_torch.kernels.group_discovery.ref import (
    KEY_NONE,
    group_discovery_ref,
)

# The table route's bound: the keys of all a launch's tables together. A
# block holds them in shared memory, a byte a key: 32 KB stays under the
# 48 KB a block gets without opting in, so three blocks fit an SM beside
# their registers, and zeroing and merging a full table costs a block 128
# bytes a thread.
GD_TABLE_KEYS = 32768
_MAX_KEY_SPACE = 2**62  # sorted-route codes are int64; KEY_NONE lies above

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"gd_launch": ([_P] * 2 + [_I] * 5 + [_P] * 3 + [_I]
                           + [_P] * 3 + [_I] + [_P] * 3)}


def _entry(name):
    fn = getattr(load("group_discovery"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


class DiscoveryPlan(NamedTuple):
    """Routes of one launch. ``gcol``/``gstride`` (P, G): each probe's
    group-by columns and their mixed-radix strides (padding: column 0,
    stride 0). ``route`` (P, 2): (offset of the probe's table in the
    presence table, its key space) on the table route, (-1, its row of
    keys) on the sorted route. ``n_keys``: the presence table's length;
    ``n_rows``: probes on the sorted route."""

    gcol: np.ndarray
    gstride: np.ndarray
    route: np.ndarray
    n_keys: int
    n_rows: int


def discovery_plan(groupby: Sequence[Tuple[int, ...]],
                   sizes: Sequence[int]) -> DiscoveryPlan:
    """Lay out the routes of probes grouping by ``groupby`` (one non-empty
    tuple of categorical columns a probe) over categories of ``sizes``."""
    n = len(groupby)
    g = max((len(cols) for cols in groupby), default=1)
    gcol = np.zeros((n, g), np.int64)
    gstride = np.zeros((n, g), np.int64)
    route = np.zeros((n, 2), np.int64)
    n_keys, n_rows = 0, 0
    for p, cols in enumerate(groupby):
        if not cols:
            raise ValueError(f"probe {p} groups by no column")
        space = math.prod(int(sizes[c]) for c in cols)
        if space > _MAX_KEY_SPACE:
            raise ValueError(f"probe {p}: a key space of {space} exceeds "
                             f"{_MAX_KEY_SPACE}")
        stride = 1
        for j in reversed(range(len(cols))):
            gcol[p, j], gstride[p, j] = cols[j], stride
            stride *= int(sizes[cols[j]])
        if n_keys + space > GD_TABLE_KEYS:
            route[p] = (-1, n_rows)
            n_rows += 1
        else:
            route[p] = (n_keys, space)
            n_keys += space
    return DiscoveryPlan(gcol, gstride, route, n_keys, n_rows)


def group_discovery(x, codes, lo, hi, member, plan: DiscoveryPlan):
    """Each probe's marks over the tuples: presence (n_keys,) uint8 and
    keys (n_rows, T) int64 (``KEY_NONE`` where the probe does not admit
    the tuple).

    x: (T,L) f64; codes: (T,C) int32 in [0, sizes); lo/hi: (P,L) f64,
    already widened by ``RANGE_EPS``; member: (P,C,V) bool.
    """
    dev = x.device
    arrays = (plan.gcol, plan.gstride, plan.route)
    meta = torch.as_tensor(np.concatenate([a.ravel() for a in arrays]),
                           device=dev)  # one copy to the card
    gcol, gstride, route = (
        part.view(a.shape)
        for part, a in zip(meta.split([a.size for a in arrays]), arrays))
    if dev.type == "cpu":
        return group_discovery_ref(x, codes, lo, hi, member, gcol, gstride,
                                   route, plan.n_keys, plan.n_rows)
    if dev.type != "cuda":
        raise ValueError(f"group_discovery: unsupported device {dev}")
    t_n, l = x.shape
    c = codes.shape[1]
    p_n, _, v = member.shape
    g = plan.gcol.shape[1]
    check_tensor(x, "x", F64, (t_n, l), dev)
    check_tensor(codes, "codes", torch.int32, (t_n, c), dev)
    check_tensor(lo, "lo", F64, (p_n, l), dev)
    check_tensor(hi, "hi", F64, (p_n, l), dev)
    check_tensor(member, "member", torch.bool, (p_n, c, v), dev)
    if plan.route.shape[0] != p_n:
        raise ValueError(f"group_discovery: a plan of {plan.route.shape[0]} "
                         f"probes for {p_n}")
    if t_n >= 2**31:
        raise ValueError(f"group_discovery: T={t_n} exceeds the kernel's "
                         "grid")
    presence = torch.zeros(plan.n_keys, dtype=torch.uint8, device=dev)
    keys = torch.empty((plan.n_rows, t_n), dtype=torch.int64, device=dev)
    err = _entry("gd_launch")(
        x.data_ptr(), codes.data_ptr(), t_n, l, c, v, p_n, lo.data_ptr(),
        hi.data_ptr(), member.data_ptr(), g, gcol.data_ptr(),
        gstride.data_ptr(), route.data_ptr(), plan.n_keys,
        presence.data_ptr(), keys.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_cuda_error(err, "group_discovery")
    count_launch(group_discovery)
    return presence, keys


group_discovery.launches = 0


def distinct_keys(keys):
    """(rows, codes) int64 of the distinct admitted codes of each row of
    ``keys``, by row, then ascending: a sort-unique on the keys' device."""
    s = keys.sort(dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    rows, cols = (new & (s != KEY_NONE)).nonzero(as_tuple=True)
    return torch.stack([rows, s[rows, cols]])
