"""Analytic inter-tuple covariance aggregation (paper §4, Appendix F).

The covariance between two snippet answers decomposes into a product over
dimension attributes (Eq. 10 / Eq. 16):

  cov(th_i, th_j) = sigma_g^2
      * prod_{k in numeric}  II_k(i, j)          (double integral of SE kernel)
      * prod_{k in categorical} |F_ik ∩ F_jk|    (membership overlap)

with AVG answers normalized by the predicate-region size |F_i||F_j|
(Appendix F.3's mu estimators imply exactly this normalization).

Plain PyTorch on whichever device the snippets live; float64 throughout
(the SE double integral is an inclusion-exclusion whose difference is
O(width²) — catastrophic cancellation in f32 for narrow predicates).
"""
from __future__ import annotations

import torch
from torch.special import erf

from repro_torch.core.types import AVG, F64, GPParams, SnippetBatch

# Widening for degenerate (equality) numeric ranges, in normalized units.
EPS_WIDTH = 1e-6
SQRT_PI = 1.7724538509055159


def _antideriv(u, z):
    """F(u) with u = x - y: d^2F/dxdy = exp(-u^2/z^2) (Appendix F.1)."""
    return (-0.5 * z * z * torch.exp(-((u / z) ** 2))
            - 0.5 * SQRT_PI * z * u * erf(u / z))


def se_double_integral(a, b, c, d, z):
    """∫_a^b ∫_c^d exp(-(x-y)^2/z^2) dy dx, elementwise/broadcast."""
    return (_antideriv(b - d, z) - _antideriv(b - c, z)
            - _antideriv(a - d, z) + _antideriv(a - c, z))


def widened(lo, hi):
    """Equality predicates arrive as zero-width ranges; widen to EPS_WIDTH."""
    w = torch.clamp(hi - lo, min=EPS_WIDTH)
    return lo, lo + w, w


def numeric_factors(bi: SnippetBatch, bj: SnippetBatch, params: GPParams):
    """(n_i, n_j) product over numeric dims of the SE double integrals, and
    the volumes ∏_k width of each side (for AVG normalization)."""
    lo_i, hi_i, w_i = widened(bi.lo, bi.hi)  # (n_i, l)
    lo_j, hi_j, w_j = widened(bj.lo, bj.hi)  # (n_j, l)
    z = params.ls  # (l,)
    g = se_double_integral(
        lo_i[:, None, :], hi_i[:, None, :], lo_j[None, :, :], hi_j[None, :, :], z
    )  # (n_i, n_j, l)
    # The SE integral is mathematically positive; clamp fp rounding.
    g = torch.clamp(g, min=0.0)
    return g.prod(-1), w_i.prod(-1), w_j.prod(-1)


def categorical_factors(bi: SnippetBatch, bj: SnippetBatch):
    """(n_i, n_j) ∏_k |F_ik ∩ F_jk| and the per-snippet counts ∏_k |F_ik|."""
    if bi.cat.shape[1] == 0:
        n_i, n_j = bi.n, bj.n
        dev = bi.device
        return (torch.ones((n_i, n_j), dtype=F64, device=dev),
                torch.ones((n_i,), dtype=F64, device=dev),
                torch.ones((n_j,), dtype=F64, device=dev))
    ci = bi.cat.to(F64)
    cj = bj.cat.to(F64)
    overlap = torch.einsum("ikv,jkv->ijk", ci, cj)  # (n_i, n_j, c)
    counts_i = ci.sum(-1).prod(-1)
    counts_j = cj.sum(-1).prod(-1)
    return overlap.prod(-1), counts_i, counts_j


def region_size(b: SnippetBatch):
    """|F_i| = numeric volume × categorical count (normalized units)."""
    _, _, w = widened(b.lo, b.hi)
    vol = w.prod(-1)
    if b.cat.shape[1] > 0:
        vol = vol * b.cat.to(F64).sum(-1).prod(-1)
    return vol


def cov_matrix(bi: SnippetBatch, bj: SnippetBatch, params: GPParams):
    """cov(exact answers) between two snippet batches: (n_i, n_j).

    Assumes both batches share one aggregate function g (Section 3.1 WLOG).
    """
    num, vol_i, vol_j = numeric_factors(bi, bj, params)
    cat, cnt_i, cnt_j = categorical_factors(bi, bj)
    raw = params.sigma2 * num * cat
    # AVG: normalize by |F_i| |F_j| (integral -> mean); FREQ: leave as integral.
    one = torch.ones((), dtype=F64, device=num.device)
    norm_i = torch.where(bi.agg == AVG, vol_i * cnt_i, one)
    norm_j = torch.where(bj.agg == AVG, vol_j * cnt_j, one)
    return raw / (norm_i[:, None] * norm_j[None, :])


def cov_diag(b: SnippetBatch, params: GPParams):
    """Prior variance kappa_bar^2 of each snippet's exact answer: (n,)."""
    lo, hi, w = widened(b.lo, b.hi)
    z = params.ls
    g = torch.clamp(se_double_integral(lo, hi, lo, hi, z), min=0.0)  # (n, l)
    num = g.prod(-1)
    vol = w.prod(-1)
    if b.cat.shape[1] > 0:
        counts = b.cat.to(F64).sum(-1).prod(-1)
    else:
        counts = torch.ones_like(vol)
    raw = params.sigma2 * num * counts
    one = torch.ones((), dtype=F64, device=vol.device)
    norm = torch.where(b.agg == AVG, (vol * counts) ** 2, one)
    return raw / norm


def prior_mean(b: SnippetBatch, params: GPParams):
    """Prior mean per snippet (Appendix F.3): AVG -> mu; FREQ -> mu * |F_i|."""
    size = region_size(b)
    return torch.where(b.agg == AVG, params.mu, params.mu * size)
