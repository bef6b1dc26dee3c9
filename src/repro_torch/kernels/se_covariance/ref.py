"""Plain PyTorch version of the SE-covariance kernel (K3), and the closed
form it is built from.

The numeric factor of cov(theta_i, theta_j) (paper Eq. 10): the product over
numeric dimensions of the closed-form SE double integral (Appendix F.1),
scaled by ``sigma2 / (norm_i * norm_j)``. ``repro_torch.core.covariance``
builds its covariances from the same ``se_double_integral``; the CPU path of
the wrapper runs ``se_cov_matrix_ref``, and on the card it is the yardstick
the kernel is held to. Its gradient with respect to the lengthscales is
autograd's (``se_cov_grad_ref``); ``se_cov_derivs_ref`` writes out the
per-dimension derivatives the card's forward saves for its backward.
"""
from __future__ import annotations

import torch
from torch.special import erf

SQRT_PI = 1.7724538509055159


def _antideriv(u, z):
    """F(u) with u = x - y: d^2F/dxdy = exp(-u^2/z^2) (Appendix F.1)."""
    return (-0.5 * z * z * torch.exp(-((u / z) ** 2))
            - 0.5 * SQRT_PI * z * u * erf(u / z))


def _antideriv_dz(u, z):
    """dF/dz: -z exp(-(u/z)^2) - (sqrt(pi)/2) u erf(u/z)."""
    return -z * torch.exp(-((u / z) ** 2)) - 0.5 * SQRT_PI * u * erf(u / z)


def se_double_integral(a, b, c, d, z, f=_antideriv):
    """∫_a^b ∫_c^d exp(-(x-y)^2/z^2) dy dx, elementwise/broadcast (with
    ``f=_antideriv_dz``, its derivative with respect to z)."""
    return f(b - d, z) - f(b - c, z) - f(a - d, z) + f(a - c, z)


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


def se_cov_derivs_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """(K, D): ``se_cov_matrix_ref(...)`` and, for each dimension k, D[k] =
    dK/dz_k = (sigma2 / (norm_i norm_j)) ∏_{j≠k} g_j · dg_k, with g_k the
    clamped integral and dg_k its z-derivative where II_k >= 0, else 0 (the
    gradient torch.clamp passes). Shapes (n_i, n_j) and (l, n_i, n_j)."""
    sides = (lo_i[:, None, :], hi_i[:, None, :], lo_j[None, :, :],
             hi_j[None, :, :])
    ii = se_double_integral(*sides, ls)
    dii = se_double_integral(*sides, ls, f=_antideriv_dz)
    g = torch.clamp(ii, min=0.0)
    dg = torch.where(ii >= 0.0, dii, torch.zeros_like(dii))
    nn = norm_i[:, None] * norm_j[None, :]
    s = sigma2 * torch.ones_like(nn) / nn  # a true division, as the kernels'
    l = g.shape[-1]
    d = []
    for k in range(l):
        others = torch.ones_like(s)
        for j in range(l):
            if j != k:
                others = others * g[..., j]
        d.append(s * others * dg[..., k])
    k_mat = sigma2 * g.prod(-1) / nn
    return k_mat, torch.stack(d) if d else g.new_zeros((0, *s.shape))
