"""Analytic inter-tuple covariance aggregation (paper §4, Appendix F).

The covariance between two snippet answers decomposes into a product over
dimension attributes (Eq. 10 / Eq. 16):

  cov(th_i, th_j) = sigma_g^2
      * prod_{k in numeric}  II_k(i, j)          (double integral of SE kernel)
      * prod_{k in categorical} |F_ik ∩ F_jk|    (membership overlap)

with AVG answers normalized by the predicate-region size |F_i||F_j|
(Appendix F.3's mu estimators imply exactly this normalization).

The numeric factor of every covariance build goes through the SE-covariance
kernel's wrappers (``repro_torch.kernels.se_covariance``): the CUDA kernels
on the card (the Gram kernel for a batch against itself; under autograd
they save the lengthscale derivatives their backward reduces), the plain
version on the CPU. Everything else is plain PyTorch on whichever
device the snippets live, float64 throughout (the SE double integral is an
inclusion-exclusion whose difference is O(width²) — catastrophic
cancellation in f32 for narrow predicates).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import AVG, F64, GPParams, SnippetBatch
from repro_torch.kernels.se_covariance import ops as se_ops
from repro_torch.kernels.se_covariance.ref import (  # noqa: F401 — re-export
    SQRT_PI,
    se_double_integral,
)

# Widening for degenerate (equality) numeric ranges, in normalized units.
EPS_WIDTH = 1e-6


def widened(lo, hi):
    """Equality predicates arrive as zero-width ranges; widen to EPS_WIDTH."""
    w = torch.clamp(hi - lo, min=EPS_WIDTH)
    return lo, lo + w, w


def numeric_factors(bi: SnippetBatch, bj: SnippetBatch, params: GPParams):
    """(n_i, n_j) product over numeric dims of the SE double integrals, and
    the volumes ∏_k width of each side (for AVG normalization).

    The product is the SE-covariance kernel's function with ``sigma2 = 1``
    and unit norms (``cov_matrix`` applies sigma², the categorical factor
    and the AVG norms outside, so only the lengthscales' gradient goes
    through the kernel). On the CPU that is exactly ``prod_k clamp(II_k,
    0)``.
    """
    lo_i, hi_i, w_i = widened(bi.lo, bi.hi)  # (n_i, l)
    ones_i = torch.ones((bi.n,), dtype=F64, device=lo_i.device)
    if bj is bi:
        # A Gram matrix (refit's NLL, ingest blocks, rebuilds): the kernel
        # computes each symmetric pair once. Told by identity: comparing
        # values would cost a device-to-host sync.
        num = se_ops.se_cov_gram(lo_i, hi_i, params.ls, 1.0, ones_i)
        vol = w_i.prod(-1)
        return num, vol, vol
    lo_j, hi_j, w_j = widened(bj.lo, bj.hi)  # (n_j, l)
    ones_j = torch.ones((bj.n,), dtype=F64, device=lo_j.device)
    num = se_ops.se_cov_matrix(lo_i, hi_i, lo_j, hi_j, params.ls, 1.0,
                               ones_i, ones_j)
    return num, w_i.prod(-1), w_j.prod(-1)


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


def analytic_sigma2_mu(b: SnippetBatch, theta):
    """Analytic estimates of (sigma_g^2, mu) from past answers (Appendix
    F.3). The variance has ddof 0, as ``jnp.var``."""
    size = region_size(b)
    dens = torch.where(b.agg == AVG, theta, theta / size)
    mu = dens.mean()
    sigma2 = torch.clamp(dens.var(correction=0), min=1e-12)
    return sigma2, mu
