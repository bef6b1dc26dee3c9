"""Minimal gradient-based minimizer (Adam) used by offline model fitting.

A Python loop over a dict of leaf tensors; each step takes
``torch.autograd.grad`` of the loss. The update is the reference's
(``repro.utils.optim.adam_minimize``), guard included: a step whose loss or
gradient is not finite (an ill-conditioned Cholesky region) skips the
parameter update, while the moments still decay and the step count still
advances.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def adam_minimize(
    loss_fn: Callable,
    params: Dict[str, torch.Tensor],
    *,
    steps: int = 200,
    lr: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """Minimize ``loss_fn(params)`` with Adam.

    ``params``: ``{name: tensor}``. Returns ``(params, history)``: the
    final parameters (detached, on their own devices) and the loss of every
    step, non-finite ones included, as a float64 tensor on the host.
    """
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    hist = []
    for i in range(steps):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = loss_fn(leaves)
        loss_val = float(loss.detach())
        ok = math.isfinite(loss_val)
        if ok:
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            ok = all(bool(torch.isfinite(g).all()) for g in grads.values())
        hist.append(loss_val)
        t = i + 1
        for k in p:
            g = grads[k] if ok else torch.zeros_like(p[k])
            m[k] = b1 * m[k] + (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * (g * g)
            if ok:
                mhat = m[k] / (1 - b1**t)
                vhat = v[k] / (1 - b2**t)
                p[k] = p[k] - lr * mhat / (torch.sqrt(vhat) + eps)
    return p, torch.tensor(hist, dtype=torch.float64)
