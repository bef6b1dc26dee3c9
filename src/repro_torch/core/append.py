"""Data-append generalization (paper Appendix D).

When r^a is appended to r, every past snippet answer computed on r is adjusted
(Lemma 3):

    theta_i'  = theta_i + f * mu_k          f = |r^a| / (|r| + |r^a|)
    beta_i'^2 = beta_i^2 + (f * eta_k)^2

where s_k ~ (mu_k, eta_k^2) models the drift of A_k between r and r^a, estimated
from small samples of both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import AVG, F64, to_numpy


@dataclasses.dataclass(frozen=True)
class AppendStats:
    """Per-measure drift statistics plus the append fraction f."""

    mu: np.ndarray  # (m,)
    eta2: np.ndarray  # (m,)
    frac: float


def estimate_append_stats(old_sample, new_sample, n_old: int, n_new: int) -> AppendStats:
    """old_sample/new_sample: (k, m) measure samples of r and r^a (arrays or
    tensors). Variances have ddof 0."""
    old = np.asarray(to_numpy(old_sample))
    new = np.asarray(to_numpy(new_sample))
    mu_old = old.mean(axis=0)
    mu_new = new.mean(axis=0)
    var_old = old.var(axis=0)
    var_new = new.var(axis=0)
    k_old = max(len(old), 1)
    k_new = max(len(new), 1)
    mu = mu_new - mu_old
    # Variance of the drift estimate: sampling noise of both means plus the
    # spread of the appended values themselves (they replace a deterministic
    # aggregate with a random one).
    eta2 = var_new + var_old / k_old + var_new / k_new
    frac = n_new / max(n_old + n_new, 1)
    return AppendStats(mu=mu, eta2=eta2, frac=frac)


def adjust_answers(theta, beta2, measure_idx, agg, stats: AppendStats):
    """Apply Lemma 3 to past AVG answers (FREQ fractions are unaffected by
    value drift; COUNT rescaling is handled by cardinality bookkeeping).

    theta, beta2: (n,) float64 tensors; measure_idx, agg: (n,) integer
    tensors on the same device."""
    mu_k = torch.as_tensor(stats.mu, dtype=F64,
                           device=theta.device)[measure_idx.long()]
    eta2_k = torch.as_tensor(stats.eta2, dtype=F64,
                             device=theta.device)[measure_idx.long()]
    f = stats.frac
    is_avg = agg == AVG
    theta_new = torch.where(is_avg, theta + f * mu_k, theta)
    beta2_new = torch.where(is_avg, beta2 + (f**2) * eta2_k, beta2)
    return theta_new, beta2_new
