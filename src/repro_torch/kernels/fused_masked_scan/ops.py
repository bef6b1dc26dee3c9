"""Public wrappers of the fused masked-scan kernel.

``fused_masked_scan`` takes the kernel's own inputs and returns the
(Q, 2M+1) accumulated columns: on a CUDA tensor it launches
``csrc/fused_masked_scan.cu`` (f64 accumulation, fixed-order two-pass fold,
bitwise the same on every run), on a CPU tensor it runs the plain version
(``ref.fused_masked_scan_ref``). Anything else raises.

``eval_partials_fused`` is the drop-in for
``repro_torch.aqp.executor.eval_partials`` that the engine's scan plane
calls: same signature including ``valid=``, same ``Partials`` out, with the
reference epilogue (gather ``sums``/``sumsq`` by ``snippets.measure``;
``scanned`` is the valid-mask sum).

``masked_partials`` is K4: the same fold over a (T, Q) mask built outside
the kernel (``csrc/fused_masked_scan.cu``, entry point ``mpa_launch``; the
plain version is ``ref.masked_partials_ref``). ``masked_partials_fused`` is
its drop-in for the gathered-mask aggregation of the sharded placement
(``repro_torch.aqp.executor.eval_partials_sharded``). On a 0/1 mask it
gives K1's bits on the same block.

Both take any number of measures: a launch folds at most ``FMS_GROUP``
(the kernels are templated on the count), so the wrappers launch once per
group of ``measure_groups(m)``, each reading its measures in place and
writing its own columns of the (Q, 2M+1) output (``group_columns``). A
column's bits do not depend on the group it rides in.
``masked_partials_plan`` is K4's launch plan (grid and scratch), which the
CPU tests check and the card holds against the built library's. K1's plan
(path, snippets a lane, grid, shared memory) is decided in the library
alone: ``fused_scan_plan`` reads it from there. Where the library takes
path 3 (category sets past a block's shared memory), the wrapper also
allocates that path's category words, as many as the plan reports.
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
from repro_torch.kernels.fused_masked_scan.ref import (
    fused_masked_scan_ref,
    masked_partials_ref,
)

FMS_CHUNK_T = 256  # tuples one block folds; fixed, so sums depend on T only
FMS_GROUP = 8  # measures one launch folds (the kernels are templated on 0..8)
MPA_TILE_Q = 128  # K4: snippets of one block (four warps, a lane a snippet)
MPA_FOLD_WIDTH = 32  # the second pass: outputs of one block

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "fms_launch": ([_P] * 4 + [_I] + [_P] * 3 + [_I] * 9 + [ctypes.c_double]
                   + [_P] * 4),
    "fms_plan": [_I] * 7 + [_P],
    "mpa_launch": [_P] * 2 + [_I] * 7 + [_P] * 3,
    "mpa_plan": [_I] * 4 + [_P],
}


def _entry(name):
    fn = getattr(load("fused_masked_scan"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def measure_groups(m):
    """[(first measure, count)] of the launches over ``m`` measures: runs of
    at most ``FMS_GROUP`` in order; one group of none when ``m`` is 0 (the
    count column alone)."""
    if m == 0:
        return [(0, 0)]
    return [(j, min(FMS_GROUP, m - j)) for j in range(0, m, FMS_GROUP)]


def group_columns(m, first, count):
    """The columns of the (Q, 2m+1) output, in ``[m, m², 1]`` order, that
    the launch over measures ``first .. first+count-1`` writes, in its own
    (Q, 2·count+1) order."""
    return ([first + j for j in range(count)]
            + [m + first + j for j in range(count)] + [2 * m])


class FusedScanPlan(NamedTuple):
    """K1's launch for one group of ``m`` measures, as the built library's
    ``fms_launch`` computes it on the current card. ``path`` 1 keeps every
    snippet's bounds and category sets in registers with 32-bit words, 2
    with 64-bit words, 0 is the kernel for any width (its category sets
    as the register path's words in registers, ``words`` 1 or 2, or as
    words in shared memory, 0), 3 that kernel's shape past a block's shared
    memory (the sets as 32-bit words in a scratch of ``word_scratch``
    words, streamed through shared memory a slice at a time); ``spl``
    snippets a lane; ``rows`` tuples a ring stage. Block ``b`` folds
    ``chunks_a_block`` chunks from ``b // n_q_tiles * chunks_a_block`` for
    snippet tile ``b % n_q_tiles``."""

    path: int
    spl: int
    tile_q: int
    n_chunks: int
    n_q_tiles: int
    blocks: int
    fold_blocks: int
    smem: int
    n_sm: int
    rows: int
    words: int
    word_scratch: int
    chunks_a_block: int


def fused_scan_plan(t_n, q_n, m, l, c, v):
    """``fms_plan`` of the built library on the current card: K1's launch
    over T tuples of L numeric and C categorical dims (V values), Q
    snippets and ``m`` <= ``FMS_GROUP`` measures."""
    out = (ctypes.c_int * len(FusedScanPlan._fields))()
    _entry("fms_plan")(t_n, q_n, m, l, c, v, FMS_CHUNK_T, out)
    return FusedScanPlan(*out)


class MaskedPartialsPlan(NamedTuple):
    """K4's launch for one group of ``m`` measures, as ``mpa_launch``
    computes it. Block ``b`` folds chunk ``b // n_q_tiles``
    (``FMS_CHUNK_T`` tuples, K1's chunks) for snippet tile ``b %
    n_q_tiles``; the second pass sums ``scratch`` over its first axis in
    ascending order."""

    t_n: int
    q_n: int
    m: int
    n_chunks: int
    n_q_tiles: int
    blocks: int
    fold_blocks: int
    scratch: tuple

    def block(self, b):
        """(tuple range, snippet range) of partial block ``b``."""
        c, qt = divmod(b, self.n_q_tiles)
        t0, q0 = c * FMS_CHUNK_T, qt * MPA_TILE_Q
        return (range(t0, min(self.t_n, t0 + FMS_CHUNK_T)),
                range(q0, min(self.q_n, q0 + MPA_TILE_Q)))


def masked_partials_plan(t_n, q_n, m):
    """K4's grid, second pass and scratch shape for a (T, Q) mask and one
    group of ``m`` <= ``FMS_GROUP`` measures."""
    n_chunks = -(-t_n // FMS_CHUNK_T)
    n_q_tiles = -(-q_n // MPA_TILE_Q)
    p = 2 * m + 1
    return MaskedPartialsPlan(
        t_n, q_n, m, n_chunks, n_q_tiles, n_chunks * n_q_tiles,
        -(-q_n * p // MPA_FOLD_WIDTH), (max(n_chunks, 1), q_n, p))


def masked_partials_plan_of_library(t_n, q_n, m):
    """``mpa_plan`` of the built library (the card's build): (chunks,
    snippet tile, q tiles, partial blocks, fold blocks)."""
    out = (ctypes.c_int * 5)()
    _entry("mpa_plan")(t_n, q_n, m, FMS_CHUNK_T, out)
    return tuple(out)


def _check_grid(what, t_n, q_n):
    if t_n >= 2**31 - FMS_CHUNK_T or (
            -(-t_n // FMS_CHUNK_T) * -(-q_n // 32) >= 2**31):
        raise ValueError(f"{what}: T={t_n}, Q={q_n} exceed the kernel's grid")


def _group_scratch(t_n, q_n, m, dev):
    """One scratch buffer for every group's launch (they run in order on
    one stream): room for the widest group."""
    g = max(count for _, count in measure_groups(m))
    return torch.empty((max(-(-t_n // FMS_CHUNK_T), 1), q_n, 2 * g + 1),
                       dtype=F64, device=dev)


def fused_masked_scan(x, codes, measures, lo, hi, cat, valid=None):
    """(Q, 2M+1) f64: ``Σ_t mask[t,q]·[m, m², 1][t]`` over the block.

    x: (T,L) f64; codes: (T,C) int32 in [0, V); measures: (T,M) f64;
    lo/hi: (Q,L) f64; cat: (Q,C,V) bool; valid: optional (T,) f64.
    """
    dev = x.device
    if dev.type == "cpu":
        return fused_masked_scan_ref(x, codes, valid, measures, lo, hi, cat)
    if dev.type != "cuda":
        raise ValueError(f"fused_masked_scan: unsupported device {dev}")
    t_n, l = x.shape
    c = codes.shape[1]
    q_n, _, v = cat.shape
    m = measures.shape[1]
    check_tensor(x, "x", F64, (t_n, l), dev)
    check_tensor(codes, "codes", torch.int32, (t_n, c), dev)
    check_tensor(measures, "measures", F64, (t_n, m), dev)
    check_tensor(lo, "lo", F64, (q_n, l), dev)
    check_tensor(hi, "hi", F64, (q_n, l), dev)
    check_tensor(cat, "cat", torch.bool, (q_n, c, v), dev)
    if valid is not None:
        check_tensor(valid, "valid", F64, (t_n,), dev)
    _check_grid("fused_masked_scan", t_n, q_n)
    out = torch.empty((q_n, 2 * m + 1), dtype=F64, device=dev)
    if q_n == 0:
        return out
    scratch = _group_scratch(t_n, q_n, m, dev)
    groups = measure_groups(m)
    n_words = max(fused_scan_plan(t_n, q_n, count, l, c, v).word_scratch
                  for _, count in groups)
    words = (torch.empty(n_words, dtype=torch.int32, device=dev)
             if n_words else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = _entry("fms_launch")
    for first, count in groups:
        err = entry(
            x.data_ptr(), codes.data_ptr(),
            None if valid is None else valid.data_ptr(),
            measures.data_ptr() + 8 * first, m, lo.data_ptr(), hi.data_ptr(),
            cat.data_ptr(), t_n, q_n, l, c, v, count, first, m, FMS_CHUNK_T,
            RANGE_EPS, scratch.data_ptr(),
            None if words is None else words.data_ptr(), out.data_ptr(),
            stream)
        check_cuda_error(err, "fused_masked_scan")
        count_launch(fused_masked_scan)
    return out


fused_masked_scan.launches = 0


def eval_partials_fused(num_normalized, cat, measures, snippets,
                        valid=None) -> Partials:
    """Kernel-backed partials for one tuple block (drop-in for
    ``eval_partials``). ``valid``: optional (T,) validity mask — invalid
    rows contribute exactly nothing and ``scanned`` is the mask sum."""
    t_n, m = measures.shape
    scanned = (torch.tensor(float(t_n), dtype=F64, device=measures.device)
               if valid is None else valid.sum())
    out = fused_masked_scan(num_normalized, cat, measures, snippets.lo,
                            snippets.hi, snippets.cat, valid)
    return partials_from_columns(out, snippets, m, scanned)


def masked_partials(mask, measures):
    """(Q, 2M+1) f64: ``Σ_t mask[t,q]·[m, m², 1][t]``, folded in K1's order.

    mask: (T,Q) f64 (the sharded placement's gathered 0/1 mask);
    measures: (T,M) f64.
    """
    dev = mask.device
    if dev.type == "cpu":
        return masked_partials_ref(mask, measures)
    if dev.type != "cuda":
        raise ValueError(f"masked_partials: unsupported device {dev}")
    t_n, q_n = mask.shape
    m = measures.shape[1]
    check_tensor(mask, "mask", F64, (t_n, q_n), dev)
    check_tensor(measures, "measures", F64, (t_n, m), dev)
    _check_grid("masked_partials", t_n, q_n)
    out = torch.empty((q_n, 2 * m + 1), dtype=F64, device=dev)
    if q_n == 0:
        return out
    scratch = _group_scratch(t_n, q_n, m, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = _entry("mpa_launch")
    for first, count in measure_groups(m):
        err = entry(mask.data_ptr(), measures.data_ptr() + 8 * first, m, t_n,
                    q_n, count, first, m, FMS_CHUNK_T, scratch.data_ptr(),
                    out.data_ptr(), stream)
        check_cuda_error(err, "masked_partials")
        count_launch(masked_partials)
    return out


masked_partials.launches = 0


def masked_partials_fused(mask, measures, snippets, scanned) -> Partials:
    """K4-backed aggregation of a pre-built (T, Q) mask (drop-in for the
    plain ``_partials_from_mask``)."""
    out = masked_partials(mask, measures)
    return partials_from_columns(out, snippets, measures.shape[1], scanned)
