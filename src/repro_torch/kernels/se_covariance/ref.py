"""Plain PyTorch version of the SE-covariance kernel (K3), and the closed
form it is built from.

The numeric factor of cov(theta_i, theta_j) (paper Eq. 10): the product over
numeric dimensions of the closed-form SE double integral (Appendix F.1),
scaled by ``sigma2 / (norm_i * norm_j)``. ``repro_torch.core.covariance``
builds its covariances from the same ``se_double_integral``; the CPU path of
the wrapper runs ``se_cov_matrix_ref``, and on the card it is the yardstick
the kernel is held to. Its gradient with respect to the lengthscales is
autograd's (``se_cov_grad_ref``).
"""
from __future__ import annotations

import torch
from torch.special import erf

SQRT_PI = 1.7724538509055159


def _antideriv(u, z):
    """F(u) with u = x - y: d^2F/dxdy = exp(-u^2/z^2) (Appendix F.1)."""
    return (-0.5 * z * z * torch.exp(-((u / z) ** 2))
            - 0.5 * SQRT_PI * z * u * erf(u / z))


def se_double_integral(a, b, c, d, z):
    """∫_a^b ∫_c^d exp(-(x-y)^2/z^2) dy dx, elementwise/broadcast."""
    return (_antideriv(b - d, z) - _antideriv(b - c, z)
            - _antideriv(a - d, z) + _antideriv(a - c, z))


def se_cov_matrix_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """lo/hi: (n, l) pre-widened ranges; ls: (l,); norm: (n,). -> (n_i, n_j)."""
    g = se_double_integral(
        lo_i[:, None, :], hi_i[:, None, :], lo_j[None, :, :], hi_j[None, :, :],
        ls)
    # The SE integral is mathematically positive; clamp fp rounding.
    g = torch.clamp(g, min=0.0)
    return sigma2 * g.prod(-1) / (norm_i[:, None] * norm_j[None, :])


def se_cov_grad_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j,
                    grad_out):
    """(l,): the gradient of ``sum(grad_out * se_cov_matrix_ref(...))``
    with respect to ``ls`` (autograd of the plain version)."""
    with torch.enable_grad():
        z = ls.detach().requires_grad_(True)
        out = se_cov_matrix_ref(lo_i, hi_i, lo_j, hi_j, z, sigma2, norm_i,
                                norm_j)
        (grad,) = torch.autograd.grad(out, z, grad_out)
    return grad
