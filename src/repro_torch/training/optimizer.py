"""Optimizers built from scratch, as the reference's.

- ``adamw``: fp32 m/v state; the default for <=10B dense archs.
- ``adafactor``: factored second moment (row/col statistics for >=2D params),
  no momentum — state is O(rows+cols) instead of O(n).

Both return an ``Optimizer`` with ``init`` and ``update(grads, state,
params, lr) -> (params, state)``, the reference's signature. ``update``
works leaf by leaf and **in place** under ``torch.no_grad()``: each
parameter and state tensor is overwritten and the same trees are returned.
At full width a tree-wide functional update would hold several float32
copies of every parameter at once (qwen2.5-3b: 3.1e9 of them); leaf by
leaf, the temporaries are a few float32 copies of the largest leaf. The
arithmetic is the reference's, op for op, in float32: the new parameter is
computed in float32 and then cast to the parameter's dtype.

Stacked layer groups keep their leading layer axis, so a decision taken on
``p.ndim`` (weight decay, Adafactor's factoring) sees the stacked leaf, as
the reference's does: a norm scale stacked as ``(repeat, d)`` is decayed
and factored, the same scale in a group of one layer, ``(d,)``, is not,
and Adafactor's update clipping takes one RMS over every layer of a leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state), in place
    name: str = "opt"


def _leaves(tree):
    return [t for _, t in tree_leaves(tree)]


def _f32_zeros(shape, like):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _apply(p, u, lr, weight_decay):
    """p <- (p.f32 - lr * (u + wd * p.f32 [ndim >= 2])) cast to p's dtype.
    Consumes ``u``."""
    p32 = p.float()
    if p.ndim >= 2:
        u.add_(p32 * weight_decay)
    u.mul_(lr)
    p.copy_(torch.sub(p32, u))


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {
            "m": tree_map(lambda p: _f32_zeros(p.shape, p), params),
            "v": tree_map(lambda p: _f32_zeros(p.shape, p), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["step"].add_(1)
        t = state["step"].float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g = g.to(torch.float32, copy=True)
            # v = b2 * v + (1 - b2) * g^2;  m = b1 * m + (1 - b1) * g
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            m.mul_(b1).add_(g.mul_(1 - b1))
            # u = (m / bc1) / (sqrt(v / bc2) + eps), into g's buffer
            torch.div(m, bc1, out=g)
            g.div_(torch.div(v, bc2).sqrt_().add_(eps))
            _apply(p, g, lr, weight_decay)
        return params, state

    return Optimizer(init, update, "adamw")


def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0) -> Optimizer:
    """Factored RMS (Shazeer & Stern 2018), momentum-free."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def state_for(p):
            if _factored(p):
                return {"vr": _f32_zeros(p.shape[:-1], p),
                        "vc": _f32_zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _f32_zeros(p.shape, p)}

        return {
            "v": tree_map(state_for, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_leaves(params)[0].device),
        }

    def _states(params, tree):
        """Each parameter's state dict, in the parameters' order."""
        if isinstance(params, dict):
            return [s for k in params for s in _states(params[k], tree[k])]
        if isinstance(params, list):
            return [s for p, t in zip(params, tree) for s in _states(p, t)]
        return [tree]

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["step"].add_(1)
        t = state["step"].float()
        rho = 1.0 - t ** (-decay)
        for p, g, s in zip(_leaves(params), _leaves(grads),
                           _states(params, state["v"])):
            g = g.float()
            g2 = torch.square(g).add_(eps)
            if _factored(p):
                vr, vc = s["vr"], s["vc"]
                vr.copy_(rho * vr + (1 - rho) * torch.mean(g2, dim=-1))
                vc.copy_(rho * vc + (1 - rho) * torch.mean(g2, dim=-2))
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                # v_hat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                v_hat = torch.mul(vr[..., None], vc[..., None, :],
                                  out=g2).div_(denom[..., None])
            else:
                v = s["v"]
                v.copy_(rho * v + (1 - rho) * g2)
                v_hat = g2.copy_(v)
            u = torch.div(g, v_hat.sqrt_(), out=v_hat)
            # update clipping (RMS(u) <= clip_threshold)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u.div_(torch.clamp(rms_u / clip_threshold, min=1.0))
            _apply(p, u, lr, weight_decay)
        return params, state

    return Optimizer(init, update, "adafactor")


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warm-up, then a cosine to 0 at ``total``; a
    0-dim float32 tensor on the CPU (a host scalar to the step), the
    reference's arithmetic in float32 op for op.

    The cosine is math.cos in float64 rounded to float32 (correctly
    rounded, the same on every host); XLA:CPU's float32 cos is not, so
    the reference's schedule differs from this one where its cos is an
    ulp off, by at most ``base_lr`` times one float32 ulp of 1.
    """
    f32 = torch.float32

    def lr(step):
        step = torch.tensor(float(step), dtype=f32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        arg = math.pi * prog
        cos_ = torch.tensor(math.cos(float(arg)), dtype=f32)
        cos = 0.5 * base_lr * (1 + cos_)
        return torch.where(step < warmup, warm, cos)

    return lr
