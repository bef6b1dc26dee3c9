"""Plain PyTorch version of the fused improved-answer kernel (Eq. 11/12).

Computes in the dtype of its inputs: float64 on the engine's default path,
float32 for the ``use_kernels=True`` precision contract. The CPU path of the
wrapper runs it; on the card it is the yardstick the kernel is held to.
``gp_posterior_ref`` (Eq. 11) and ``combine_ref`` (Eq. 12) are its two
halves, which ``repro_torch.core.inference`` exposes as they are.
"""
from __future__ import annotations

import torch

GAMMA_FLOOR = 1e-30


def gp_posterior_ref(k_mat, kappa2, sigma_inv, alpha, mu_new):
    """Eq. 11: (theta_prior, gamma2), each (Q,), for k_mat (Q,C), kappa2 and
    mu_new (Q,), sigma_inv (C,C) and alpha = Sigma^{-1} resid (C,)."""
    t = k_mat @ sigma_inv
    gamma2 = torch.clamp(kappa2 - (t * k_mat).sum(-1), min=GAMMA_FLOOR)
    prior = mu_new + k_mat @ alpha
    return prior, gamma2


def combine_ref(theta_prior, gamma2, raw_theta, raw_beta2):
    """Eq. 12, the product-of-Gaussians blend; an exact raw answer
    (beta^2 <= 0) passes through with beta^2 = 0."""
    denom = raw_beta2 + gamma2
    theta = (raw_beta2 * theta_prior + gamma2 * raw_theta) / denom
    beta2 = raw_beta2 * gamma2 / denom
    exact = raw_beta2 <= 0.0
    theta = torch.where(exact, raw_theta, theta)
    beta2 = torch.where(exact, torch.zeros_like(beta2), beta2)
    return theta, beta2


def gp_batch_infer_ref(k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                       raw_beta2):
    """k_mat (Q,C); sigma_inv (C,C); alpha (C,); kappa2, mu_new, raw_theta,
    raw_beta2 (Q,) → (theta, beta2, gamma2), each (Q,)."""
    prior, gamma2 = gp_posterior_ref(k_mat, kappa2, sigma_inv, alpha, mu_new)
    theta, beta2 = combine_ref(prior, gamma2, raw_theta, raw_beta2)
    return theta, beta2, gamma2
