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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.aqp.executor import Partials, partials_from_columns
from repro_torch.core.types import F64
from repro_torch.kernels import (
    RANGE_EPS,
    check_cuda_error,
    check_tensor,
    load,
)
from repro_torch.kernels.fused_masked_scan.ref import (
    fused_masked_scan_ref,
    masked_partials_ref,
)

FMS_CHUNK_T = 256  # tuples one block folds; fixed, so sums depend on T only
FMS_MAX_MEASURES = 8  # the kernel keeps 2·8+1 accumulators in registers

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "fms_launch": [_P] * 7 + [_I] * 7 + [ctypes.c_double] + [_P] * 3,
    "mpa_launch": [_P] * 2 + [_I] * 4 + [_P] * 3,
}


def _entry(name):
    fn = getattr(load("fused_masked_scan"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_grid(what, t_n, q_n):
    if q_n > 65535 * 128 or t_n >= 2**31 - FMS_CHUNK_T:
        raise ValueError(f"{what}: T={t_n}, Q={q_n} exceed the kernel's grid")


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
    p = 2 * m + 1
    if m > FMS_MAX_MEASURES:
        raise ValueError(f"fused_masked_scan takes at most {FMS_MAX_MEASURES}"
                         f" measures, got {m}")
    check_tensor(x, "x", F64, (t_n, l), dev)
    check_tensor(codes, "codes", torch.int32, (t_n, c), dev)
    check_tensor(measures, "measures", F64, (t_n, m), dev)
    check_tensor(lo, "lo", F64, (q_n, l), dev)
    check_tensor(hi, "hi", F64, (q_n, l), dev)
    check_tensor(cat, "cat", torch.bool, (q_n, c, v), dev)
    if valid is not None:
        check_tensor(valid, "valid", F64, (t_n,), dev)
    n_chunks = -(-t_n // FMS_CHUNK_T)
    _check_grid("fused_masked_scan", t_n, q_n)
    out = torch.empty((q_n, p), dtype=F64, device=dev)
    if q_n == 0:
        return out
    scratch = torch.empty((max(n_chunks, 1), q_n, p), dtype=F64, device=dev)
    err = _entry("fms_launch")(
        x.data_ptr(), codes.data_ptr(),
        None if valid is None else valid.data_ptr(),
        measures.data_ptr(), lo.data_ptr(), hi.data_ptr(), cat.data_ptr(),
        t_n, q_n, l, c, v, m, FMS_CHUNK_T, RANGE_EPS,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "fused_masked_scan")
    fused_masked_scan.launches += 1
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
    if m > FMS_MAX_MEASURES:
        raise ValueError(f"masked_partials takes at most {FMS_MAX_MEASURES} "
                         f"measures, got {m}")
    check_tensor(mask, "mask", F64, (t_n, q_n), dev)
    check_tensor(measures, "measures", F64, (t_n, m), dev)
    _check_grid("masked_partials", t_n, q_n)
    n_chunks = -(-t_n // FMS_CHUNK_T)
    out = torch.empty((q_n, 2 * m + 1), dtype=F64, device=dev)
    if q_n == 0:
        return out
    scratch = torch.empty((max(n_chunks, 1), q_n, 2 * m + 1), dtype=F64,
                          device=dev)
    err = _entry("mpa_launch")(
        mask.data_ptr(), measures.data_ptr(), t_n, q_n, m, FMS_CHUNK_T,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "masked_partials")
    masked_partials.launches += 1
    return out


masked_partials.launches = 0


def masked_partials_fused(mask, measures, snippets, scanned) -> Partials:
    """K4-backed aggregation of a pre-built (T, Q) mask (drop-in for the
    plain ``_partials_from_mask``)."""
    out = masked_partials(mask, measures)
    return partials_from_columns(out, snippets, measures.shape[1], scanned)
