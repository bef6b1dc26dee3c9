"""Offline correlation-parameter learning (paper Appendix A).

Maximizes the log marginal likelihood of past raw answers (Eq. 13):

    log Pr(theta_past | Sigma_n) =
        -1/2 r^T Sigma_n^{-1} r - 1/2 log|Sigma_n| - n/2 log 2pi,
    r = theta_past - mu,   Sigma_n = sigma^2 K(ls) + diag(beta^2)

The Cholesky NLL is differentiated exactly with autograd and minimized with
Adam on log-lengthscales. On the card the covariance's numeric factor and its
gradient are the SE-covariance kernels. sigma_g^2 defaults to the analytic
estimate of Appendix F.3 (joint learning with ``learn_sigma=True``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import covariance
from repro_torch.core.types import GPParams, SnippetBatch
from repro_torch.utils.optim import adam_minimize

LOG2PI = 1.8378770664093453


def nll(params: GPParams, snippets: SnippetBatch, theta, beta2, jitter=1e-10):
    """Negative Eq. (13); differentiable w.r.t. params.

    A covariance that is not positive definite gives a NaN loss (the
    reference's Cholesky returns NaN there), which Adam's guard skips.
    """
    n = theta.shape[0]
    sigma = covariance.cov_matrix(snippets, snippets, params) + torch.diag(beta2)
    sigma = sigma + jitter * torch.eye(n, dtype=sigma.dtype,
                                       device=sigma.device)
    chol, info = torch.linalg.cholesky_ex(sigma)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    resid = theta - covariance.prior_mean(snippets, params)
    w = torch.linalg.solve_triangular(chol, resid[:, None], upper=False)[:, 0]
    return (0.5 * torch.sum(w * w) + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * LOG2PI)


def fit(
    snippets: SnippetBatch,
    theta,
    beta2,
    schema,
    *,
    steps: int = 150,
    lr: float = 0.1,
    learn_sigma: bool = False,
    init: GPParams | None = None,
) -> Tuple[GPParams, torch.Tensor]:
    """Learn lengthscales (and optionally sigma^2) from the synopsis content.

    Runs on the snippets' device. Returns the fitted params and the loss
    history (host float64, one entry per step).
    """
    sigma2, mu = covariance.analytic_sigma2_mu(snippets, theta)
    if init is None:
        init = GPParams.init(schema, device=snippets.device)
    base = GPParams(log_ls=init.log_ls.to(snippets.device),
                    log_sigma2=torch.log(sigma2), mu=mu)

    if learn_sigma:
        free0 = {"log_ls": base.log_ls, "log_sigma2": base.log_sigma2}
    else:
        free0 = {"log_ls": base.log_ls}

    def loss(free):
        p = GPParams(
            log_ls=free["log_ls"],
            log_sigma2=free.get("log_sigma2", base.log_sigma2),
            mu=base.mu,
        )
        # Soft prior keeping lengthscales in a sane band (normalized units).
        reg = 1e-3 * torch.sum(free["log_ls"] ** 2)
        return nll(p, snippets, theta, beta2) + reg

    free, hist = adam_minimize(loss, free0, steps=steps, lr=lr)
    fitted = GPParams(
        log_ls=free["log_ls"],
        log_sigma2=free.get("log_sigma2", base.log_sigma2).detach(),
        mu=base.mu.detach(),
    )
    return fitted, hist
