"""Verdict inference: the most-likely answer to a new snippet (paper §3, §5).

The O(n^2) block forms of Eq. (11)/(12):

    gamma^2   = kappa_bar^2 - k_n^T Sigma_n^{-1} k_n
    theta_pri = mu_new + k_n^T Sigma_n^{-1} (theta_n - mu_n)
    theta_dd  = (beta^2 * theta_pri + gamma^2 * theta_raw) / (beta^2 + gamma^2)
    beta_dd^2 = (beta^2 * gamma^2) / (beta^2 + gamma^2)

The math has one home, the ``gp_batch_infer`` kernel's plain version
(``repro_torch.kernels.gp_batch_infer.ref``): ``gp_posterior`` and
``combine`` are its two halves, and ``model_based_answer`` is the kernel's
wrapper, which launches the kernel for CUDA tensors and runs the plain
version for CPU tensors. Every function takes tensors on any device and
computes in their dtype. The synopsis rebuilds Sigma_n^{-1} from a Cholesky
factor every ``REFACTOR_EVERY`` updates (``factorize``,
``inverse_from_chol``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gp_batch_infer.ops import gp_batch_infer
from repro_torch.kernels.gp_batch_infer.ref import (
    GAMMA_FLOOR,
    combine_ref as combine,
    gp_posterior_ref as gp_posterior,
)

__all__ = ["GAMMA_FLOOR", "chol_append_row", "combine", "factorize",
           "gp_posterior", "inverse_from_chol", "model_based_answer"]


def factorize(sigma_n, jitter: float = 1e-10):
    """Cholesky of the past-answer covariance (adds jitter on the diagonal)."""
    n = sigma_n.shape[0]
    eye = torch.eye(n, dtype=sigma_n.dtype, device=sigma_n.device)
    return torch.linalg.cholesky(sigma_n + jitter * eye)


def chol_append_row(chol, new_col, new_diag, jitter: float = 1e-10):
    """O(n^2) Cholesky update appending one row/col to Sigma_n.

    chol: (n, n) lower factor; new_col: (n,) cov vs existing; new_diag: a
    scalar. Returns the (n+1, n+1) factor.
    """
    n = chol.shape[0]
    if n:
        w = torch.linalg.solve_triangular(chol, new_col.reshape(n, 1),
                                          upper=False)[:, 0]
    else:
        w = torch.zeros((0,), dtype=chol.dtype, device=chol.device)
    d = torch.sqrt(torch.clamp(
        torch.as_tensor(new_diag, dtype=chol.dtype, device=chol.device)
        + jitter - torch.sum(w * w), min=jitter))
    out = torch.zeros((n + 1, n + 1), dtype=chol.dtype, device=chol.device)
    out[:n, :n] = chol
    out[n, :n] = w
    out[n, n] = d
    return out


def inverse_from_chol(chol):
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_l.T @ inv_l


def model_based_answer(k_mat, kappa2, sigma_inv, alpha, mu_new, raw_theta,
                       raw_beta2):
    """The full Eq. 11+12 pipeline, batched over Q new snippets, in the
    inputs' dtype (float64 or float32); returns (theta_dd, beta2_dd,
    gamma2)."""
    return gp_batch_infer(k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                          raw_beta2, dtype=k_mat.dtype)
