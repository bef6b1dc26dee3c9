"""Verdict inference helpers: the Cholesky route to Sigma_n^{-1} (paper §3, §5).

The synopsis rebuilds Sigma_n^{-1} from a Cholesky factor every
``REFACTOR_EVERY`` updates (numerical hygiene). The Eq. 11/12 improve math
itself — gamma^2, the prior and the product-of-Gaussians blend — is the
``gp_batch_infer`` kernel (``repro_torch.kernels.gp_batch_infer``), with its
plain PyTorch version beside it.
"""
from __future__ import annotations

import torch


def factorize(sigma_n, jitter: float = 1e-10):
    """Cholesky of the past-answer covariance (adds jitter on the diagonal)."""
    n = sigma_n.shape[0]
    eye = torch.eye(n, dtype=sigma_n.dtype, device=sigma_n.device)
    return torch.linalg.cholesky(sigma_n + jitter * eye)


def inverse_from_chol(chol):
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_l.T @ inv_l
