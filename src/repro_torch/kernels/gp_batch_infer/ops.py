"""Public wrapper of the fused improved-answer kernel (Eq. 11/12).

``gp_batch_infer`` computes in ``dtype``: float64 (the engine's default,
``use_kernels=False``) or float32 (the reference kernel's precision,
``use_kernels=True``). On CUDA tensors it launches
``csrc/gp_batch_infer.cu`` instantiated for that type; on CPU tensors it
runs the plain version (``ref.gp_batch_infer_ref``) in that type. Anything
else raises. Inputs are cast to ``dtype`` (no copy when they already have
it); outputs come back in ``dtype``. ``gp_plan`` is the kernel's launch
plan (grid, depth split and scratch), which the CPU tests check.

``live``: how many of C's columns can be nonzero (a synopsis' fill; K is
zero past it). The depth split follows the power of two covering ``live``
(``gp_split_basis``), and the kernel covers only those columns, so a fill
padded to any C gives the bits it gives at its own bucket.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import (
    check_cuda_error,
    check_tensor,
    count_launch,
    load,
)
from repro_torch.kernels.gp_batch_infer.ref import gp_batch_infer_ref

# The kernel's two tilings (see the .cu): a block covers GP_TILE_Q rows of
# K and GP_TILE_C columns of Σ⁻¹, or GP_TILE_Q_NARROW rows and
# GP_TILE_C_NARROW columns when Q is at most GP_TILE_Q_NARROW, and
# ``gp_depth_split(gp_split_basis(C, live))`` of C's depth.
GP_TILE_Q, GP_TILE_C = 128, 64
GP_TILE_Q_NARROW, GP_TILE_C_NARROW = 32, 64
GP_SPLIT_STEP = 32  # a split is a multiple of this (whole ring stages)
GP_SLOTS, GP_SLOT_COLS = 2 * 132, 64  # the split aims at 264 64-column blocks
GP_SPLIT_MIN = 64


def gp_depth_split(c_split):
    """Depth of one split (``depth_split`` in the .cu): a function of the
    split basis alone, so the split never depends on Q nor on padding."""
    n_ct = -(-c_split // GP_SLOT_COLS)
    want = GP_SLOTS // n_ct if n_ct > 0 and GP_SLOTS // n_ct > 1 else 1
    kd = -(-(-(-c_split // want)) // GP_SPLIT_STEP) * GP_SPLIT_STEP
    return max(kd, GP_SPLIT_MIN)


def gp_split_basis(c_n, live=None):
    """C_split: the power of two, at least 8, that covers the ``live``
    columns of C (all of C when ``live`` is None). The kernel's split is
    its function, and it covers min(C, C_split) columns."""
    n = c_n if live is None else int(live)
    if not 0 <= n <= c_n:
        raise ValueError(f"live columns {n} outside C = {c_n}")
    b = 8
    while b < n:
        b *= 2
    return b

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"gp_launch_f64": [_P] * 7 + [_I] * 3 + [_P] * 6,
             "gp_launch_f32": [_P] * 7 + [_I] * 3 + [_P] * 6,
             "gp_plan": [_I, _I, _I, _P]}
_ENTRY = {torch.float64: "gp_launch_f64", torch.float32: "gp_launch_f32"}


def _entry(name):
    fn = getattr(load("gp_batch_infer"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


class GpPlan(NamedTuple):
    """K2's launch as ``gp_launch`` computes it. Partial block
    ``(ct, split, rt)`` covers rows ``rt``, Σ⁻¹ columns ``ct`` and depth
    ``split`` of the first ``extent`` = min(C, C_split) columns; it writes
    ``part_g[row, ct, split]`` and, for split 0, ``part_t[row, ct]``. One
    buffer holds theta, beta2, gamma2, part_t and part_g, in that
    order."""

    q_n: int
    c_n: int
    tile_q: int
    tile_c: int
    split: int
    n_row_tiles: int
    n_col_tiles: int
    n_splits: int
    c_split: int
    extent: int

    @property
    def blocks(self):
        return self.n_row_tiles * self.n_col_tiles * self.n_splits

    @property
    def part_g(self):
        return (self.q_n, self.n_col_tiles, self.n_splits)

    @property
    def part_t(self):
        return (self.q_n, self.n_col_tiles)

    @property
    def scratch_elems(self):
        return self.q_n * (3 + self.n_col_tiles * (self.n_splits + 1))

    def block(self, ct, split, rt):
        """(rows, columns, depth) ranges of partial block (ct, split, rt)."""
        def cut(i, width, n):
            return range(i * width, min(n, (i + 1) * width))
        return (cut(rt, self.tile_q, self.q_n),
                cut(ct, self.tile_c, self.extent),
                cut(split, self.split, self.extent))


def gp_plan(q_n, c_n, live=None):
    """K2's tiling, depth split and scratch layout for Q new snippets
    against C past ones, ``live`` of them nonzero (all by default)."""
    narrow = q_n <= GP_TILE_Q_NARROW
    tq, tc = ((GP_TILE_Q_NARROW, GP_TILE_C_NARROW) if narrow
              else (GP_TILE_Q, GP_TILE_C))
    c_split = gp_split_basis(c_n, live)
    extent = min(c_n, c_split)
    kd = gp_depth_split(c_split)
    return GpPlan(q_n, c_n, tq, tc, kd, -(-q_n // tq), -(-extent // tc),
                  -(-extent // kd), c_split, extent)


def gp_plan_of_library(q_n, c_n, live=None):
    """``gp_plan`` of the built library (the card's build): (row tile,
    column tile, depth split, row tiles, column tiles, splits, shared
    memory a block in f64, ring stages in f64)."""
    out = (ctypes.c_int * 8)()
    _entry("gp_plan")(q_n, c_n, gp_split_basis(c_n, live), out)
    return tuple(out)


def gp_batch_infer(k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                   raw_beta2, dtype=torch.float64, live=None):
    """(theta_dd, beta2_dd, gamma2) for Q new snippets against C past ones.

    k_mat (Q,C); sigma_inv (C,C); alpha (C,); kappa2, mu_new, raw_theta,
    raw_beta2 (Q,). ``live``: the columns of C that can be nonzero (a
    synopsis' fill); ``k_mat`` must be zero past them. The plain version
    computes over all of C.
    """
    if dtype not in _ENTRY:
        raise TypeError(f"gp_batch_infer computes in float64 or float32, "
                        f"not {dtype}")
    args = [a if a.dtype == dtype else a.to(dtype)
            for a in (k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                      raw_beta2)]
    dev = k_mat.device
    if dev.type == "cpu":
        return gp_batch_infer_ref(*args)
    if dev.type != "cuda":
        raise ValueError(f"gp_batch_infer: unsupported device {dev}")
    k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta, raw_beta2 = args
    q_n, c_n = k_mat.shape
    check_tensor(k_mat, "k_mat", dtype, (q_n, c_n), dev)
    check_tensor(sigma_inv, "sigma_inv", dtype, (c_n, c_n), dev)
    check_tensor(alpha, "alpha", dtype, (c_n,), dev)
    for name, v in (("kappa2", kappa2), ("mu_new", mu_new),
                    ("raw_theta", raw_theta), ("raw_beta2", raw_beta2)):
        check_tensor(v, name, dtype, (q_n,), dev)
    plan = gp_plan(q_n, c_n, live)
    buf = torch.empty((plan.scratch_elems,), dtype=dtype, device=dev)
    theta, beta2, gamma2 = buf[:3 * q_n].view(3, q_n)
    if q_n == 0:
        return theta, beta2, gamma2
    # Pointers into the one buffer: theta, beta2, gamma2, part_t, part_g.
    base, size = buf.data_ptr(), buf.element_size()
    part_t = base + 3 * q_n * size
    part_g = part_t + q_n * plan.n_col_tiles * size
    err = _entry(_ENTRY[dtype])(
        k_mat.data_ptr(), sigma_inv.data_ptr(), alpha.data_ptr(),
        kappa2.data_ptr(), mu_new.data_ptr(), raw_theta.data_ptr(),
        raw_beta2.data_ptr(), q_n, c_n, plan.c_split, part_g, part_t, base,
        base + q_n * size, base + 2 * q_n * size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "gp_batch_infer")
    count_launch(gp_batch_infer)
    return theta, beta2, gamma2


gp_batch_infer.launches = 0
