"""Train step factory: microbatched gradient accumulation, mixed precision,
global-norm clipping, schedule — the reference's ``make_train_step``.

The global batch arrives as (accum, micro_batch, seq): the step takes each
microbatch in order, adds its gradients into float32 buffers of the
parameters' shapes (so the activation working set is one microbatch deep),
divides by ``accum``, clips, and applies one optimizer step in place.
Gradients come from ``value_and_grad``; each layer is recomputed in the
backward (``transformer.forward``'s ``remat``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.ft.checkpoint import _leaves as sorted_leaves
from repro_torch.models.common import ShardCtx
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import Optimizer


def global_norm(tree):
    """sqrt of the sum over leaves (in the reference's sorted-key order) of
    each leaf's float32 sum of squares; a 0-dim float32 tensor."""
    total = 0
    for _, x in sorted_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm):
    """(the tree scaled by min(1, max_norm / (norm + 1e-9)), norm). A
    leaf narrower than float32 comes back in float32, as JAX promotes it
    against the float32 scale."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x.to(torch.promote_types(x.dtype, scale.dtype))
                    * scale, tree), norm


def value_and_grad(cfg, params, batch, sctx: ShardCtx = ShardCtx(), *,
                   loss_fn: Optional[Callable] = None):
    """(loss, gradient tree) of ``loss_fn`` (default ``lm_loss``) at
    ``params``, the gradients in the parameters' dtypes: the reference's
    ``jax.value_and_grad``. ``torch.autograd.grad`` is taken with respect
    to detached aliases of the leaves, so the caller's tensors keep
    ``requires_grad=False``; a leaf the loss does not reach gets zeros, as
    JAX gives it."""
    leaves = [t for _, t in tree_leaves(params)]
    alias = [p.detach().requires_grad_() for p in leaves]
    it = iter(alias)
    with torch.enable_grad():
        loss = (loss_fn or lm_loss)(cfg, tree_map(lambda _: next(it), params),
                                    batch, sctx)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg, opt: Optimizer, sctx: ShardCtx = ShardCtx(), *,
                    accum: int = 1, clip_norm: float = 1.0,
                    loss_fn: Optional[Callable] = None,
                    grad_transform: Optional[Callable] = None):
    """Returns step(params, opt_state, batch, lr) -> (params, opt_state,
    metrics); ``params`` and ``opt_state`` are updated in place.

    batch leaves are shaped (accum, micro, ...) and lie on the parameters'
    device; ``grad_transform`` (float32 gradient tree -> tree) hooks
    cross-pod gradient compression. ``metrics`` holds 0-dim tensors on
    the device: ``loss`` (the microbatches' mean) and ``grad_norm``
    (before clipping).
    """

    def step(params, opt_state, batch, lr):
        acc = None
        loss_sum = 0.0
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss, grads = value_and_grad(cfg, params, mb, sctx,
                                         loss_fn=loss_fn)
            grads = [g for _, g in tree_leaves(grads)]
            if accum == 1:
                acc = [g.float() for g in grads]
            elif acc is None:  # 0 + g: the reference's zeros + first grads
                acc = [g.to(torch.float32, copy=True) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)  # float32 sum; a bf16 g is widened exactly
            del grads
            loss_sum = loss_sum + loss
        if accum > 1:
            for a in acc:
                a.div_(accum)
            loss = loss_sum / accum
        it = iter(acc)
        grads = tree_map(lambda _: next(it), params)
        del acc, it
        if grad_transform is not None:
            grads = grad_transform(grads)
        # clip_by_global_norm, scaling the float32 buffers in place
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        tree_map(lambda g: g.mul_(scale), grads)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step
