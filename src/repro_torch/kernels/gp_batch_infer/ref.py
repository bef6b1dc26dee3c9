"""Plain PyTorch version of the fused improved-answer kernel (Eq. 11/12).

Computes in the dtype of its inputs: float64 on the engine's default path,
float32 for the ``use_kernels=True`` precision contract. The CPU path of the
wrapper runs it; on the card it is the yardstick the kernel is held to.
"""
from __future__ import annotations

import torch

GAMMA_FLOOR = 1e-30


def gp_batch_infer_ref(k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                       raw_beta2):
    """k_mat (Q,C); sigma_inv (C,C); alpha (C,); kappa2, mu_new, raw_theta,
    raw_beta2 (Q,) → (theta, beta2, gamma2), each (Q,)."""
    t = k_mat @ sigma_inv
    gamma2 = torch.clamp(kappa2 - (t * k_mat).sum(-1), min=GAMMA_FLOOR)
    prior = mu_new + k_mat @ alpha
    denom = raw_beta2 + gamma2
    theta = (raw_beta2 * prior + gamma2 * raw_theta) / denom
    beta2 = raw_beta2 * gamma2 / denom
    exact = raw_beta2 <= 0.0
    theta = torch.where(exact, raw_theta, theta)
    beta2 = torch.where(exact, torch.zeros_like(beta2), beta2)
    return theta, beta2, gamma2
