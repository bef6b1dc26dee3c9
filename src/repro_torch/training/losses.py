"""Training losses."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ShardCtx


def lm_loss(cfg, params, batch, sctx: ShardCtx = ShardCtx(), *,
            remat: bool = True):
    """Next-token cross entropy. batch: {'tokens', 'labels', ['ctx'|'enc']}.

    labels == -1 positions are masked out. ``remat`` recomputes each layer
    in the backward (``transformer.forward``).
    """
    ctx_tokens = batch.get("ctx")
    if cfg.enc_dec:
        ctx_tokens = T.encode(cfg, params, batch["enc"], sctx, remat=remat)
    logits, _ = T.forward(cfg, params, batch["tokens"], sctx,
                          ctx_tokens=ctx_tokens, mode="train", remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
