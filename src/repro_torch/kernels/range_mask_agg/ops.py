"""Public wrappers of the range-mask aggregation kernel (float32).

``range_mask_agg`` takes the kernel's own inputs and returns the (Q, P)
float32 sums: on a CUDA tensor it launches ``csrc/range_mask_agg.cu``
(float32 compares and accumulation, fixed-order two-pass fold, bitwise the
same on every run), on a CPU tensor it runs the plain version
(``ref.range_mask_agg_ref``). Anything else raises. It takes any payload
width in one launch: the kernel cuts the columns into groups a warp folds
(at most 20 columns each), whose warps run side by side over the same
(T, Q) mask, each on its own columns. The grouping is decided in the C
file alone; ``range_mask_agg_plan`` reads it from the built library.

``eval_partials_kernel`` is a drop-in for
``repro_torch.aqp.executor.eval_partials``: categorical membership and
validity become the (T, Q) extra mask in plain PyTorch
(``categorical_premask``, outside the kernel as in the reference), the
kernel folds ``[m, m², 1]`` in float32, and the sums come back as float64.
``scanned`` is the valid-mask sum.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.aqp.executor import Partials, partials_from_columns
from repro_torch.core.types import F64
from repro_torch.kernels import (
    RANGE_EPS,
    check_cuda_error,
    check_tensor,
    count_launch,
    load,
)
from repro_torch.kernels.range_mask_agg.ref import F32, range_mask_agg_ref

RMA_CHUNK_T = 256  # tuples one block folds; fixed, so sums depend on T only

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "rma_launch": ([_P, _P, _I] + [_P] * 3 + [_I] * 5 + [ctypes.c_float]
                   + [_P] * 2 + [_I, _P]),
    "rma_plan": [_I] * 5 + [_P],
}


class RangeMaskAggPlan(NamedTuple):
    """K5's launch as the built library's ``rma_launch`` computes it:
    columns a group (the last group folds zero columns up to it), groups,
    groups a block, snippet tiles a block (a warp for each tile and group),
    partial blocks, dynamic shared memory a block (bytes) and second-pass
    blocks."""

    group_width: int
    groups: int
    groups_a_block: int
    tiles: int
    blocks: int
    smem: int
    fold_blocks: int


def range_mask_agg_plan(t_n, q_n, l, p):
    """``rma_plan`` of the built library (the card's build)."""
    out = (ctypes.c_int * len(RangeMaskAggPlan._fields))()
    _entry("rma_plan")(t_n, q_n, l, p, RMA_CHUNK_T, out)
    return RangeMaskAggPlan(*out)


def _entry(name):
    fn = getattr(load("range_mask_agg"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def range_mask_agg(x, payload, lo, hi, extra_mask=None):
    """(Q, P) float32: ``Σ_t mask[t,q]·extra[t,q]·payload[t,p]``.

    x: (T,L); payload: (T,P); lo/hi: (Q,L); extra_mask: (T,Q) or None (all
    ones). Inputs are cast to float32.
    """
    dev = x.device
    if dev.type == "cpu":
        return range_mask_agg_ref(x, payload, lo, hi, extra_mask)
    if dev.type != "cuda":
        raise ValueError(f"range_mask_agg: unsupported device {dev}")
    t_n, l = x.shape
    q_n = lo.shape[0]
    p = payload.shape[1]
    if t_n >= 2**31 - RMA_CHUNK_T or (
            -(-t_n // RMA_CHUNK_T) * -(-q_n // 32) >= 2**31):
        raise ValueError(f"range_mask_agg: T={t_n}, Q={q_n} exceed the "
                         "kernel's grid")
    if extra_mask is None:
        extra_mask = torch.ones((t_n, q_n), dtype=F32, device=dev)
    x, payload, lo, hi, extra_mask = (
        v.to(F32).contiguous() for v in (x, payload, lo, hi, extra_mask))
    check_tensor(x, "x", F32, (t_n, l), dev)
    check_tensor(payload, "payload", F32, (t_n, p), dev)
    check_tensor(lo, "lo", F32, (q_n, l), dev)
    check_tensor(hi, "hi", F32, (q_n, l), dev)
    check_tensor(extra_mask, "extra_mask", F32, (t_n, q_n), dev)
    out = torch.empty((q_n, p), dtype=F32, device=dev)
    if q_n == 0 or p == 0:
        return out
    n_chunks = -(-t_n // RMA_CHUNK_T)
    scratch = torch.empty((max(n_chunks, 1), p, q_n), dtype=F32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("rma_launch")(
        x.data_ptr(), payload.data_ptr(), p, lo.data_ptr(), hi.data_ptr(),
        extra_mask.data_ptr(), t_n, q_n, l, p, RMA_CHUNK_T, RANGE_EPS,
        scratch.data_ptr(), out.data_ptr(), p, stream)
    check_cuda_error(err, "range_mask_agg")
    count_launch(range_mask_agg)
    return out


range_mask_agg.launches = 0


def categorical_premask(cat_codes, snip_cat):
    """(T, Q) float32 categorical membership: tuple t's code of every
    categorical dim lies in snippet q's value set.

    cat_codes: (T, c) int; snip_cat: (Q, c, V) bool.
    """
    mask = torch.ones((cat_codes.shape[0], snip_cat.shape[0]), dtype=F32,
                      device=cat_codes.device)
    for k in range(cat_codes.shape[1]):
        member = snip_cat[:, k, :].index_select(1, cat_codes[:, k].long())
        mask = mask * member.T.to(F32)
    return mask


def eval_partials_kernel(num_normalized, cat, measures, snippets,
                         valid=None) -> Partials:
    """Kernel-backed partials for one tuple block (drop-in for
    ``eval_partials``), accumulated in float32. ``valid``: optional (T,)
    validity mask — invalid rows contribute nothing and ``scanned`` is the
    mask sum."""
    t_n, m = measures.shape
    q_n = snippets.lo.shape[0]
    meas32 = measures.to(F32)
    payload = torch.cat([meas32, meas32 * meas32,
                         meas32.new_ones((t_n, 1))], 1)  # (T, 2M+1)
    extra = categorical_premask(cat, snippets.cat) if cat.shape[1] else None
    scanned = (torch.tensor(float(t_n), dtype=F64, device=measures.device)
               if valid is None else valid.sum())
    if valid is not None:
        v = valid.to(F32)[:, None]
        extra = (v.expand(t_n, q_n) if extra is None else extra * v)
    out = range_mask_agg(num_normalized, payload, snippets.lo, snippets.hi,
                         extra).to(F64)  # (Q, 2M+1)
    return partials_from_columns(out, snippets, m, scanned)
