"""LM serving steps: prefill (prompt -> caches) and decode (one token a
step), and greedy ``generate`` over them.

Each step runs under ``torch.inference_mode`` on the card unless built with
``device="cpu"``; the parameters must already lie there. Caches are
allocated by the prefill step and written in place by every later step
(ring-bounded KV for local-attention layers, constant-size recurrent state
for SSM layers). The decode loop keeps the next token on the device: no
step copies to the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ShardCtx


def _plan(cfg):
    return cfg.decoder_plan() if cfg.enc_dec else cfg.layer_plan()


def _on(x, dev):
    return None if x is None else torch.as_tensor(x, device=dev)


def _check_params(params, dev):
    where = params["embed"].device
    if where != dev:
        raise ValueError(f"the parameters lie on {where}, the step runs on "
                         f"{dev}: move them first (Decoder.to)")


def make_prefill_step(cfg, sctx: ShardCtx = ShardCtx(), *, max_len: int,
                      n_ctx: int = 0, device=None):
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(params, tokens, ctx_tokens=None, enc_embeds=None):
        """tokens: (B,S) prompt. Returns (last logits (B,V), caches)."""
        _check_params(params, dev)
        tokens = _on(tokens, dev).long()
        caches = T.init_cache(cfg, _plan(cfg), tokens.shape[0], max_len,
                              n_ctx, device=dev)
        ctx_tokens = _on(ctx_tokens, dev)
        if cfg.enc_dec:
            ctx_tokens = T.encode(cfg, params, _on(enc_embeds, dev), sctx)
        logits, caches = T.forward(cfg, params, tokens, sctx,
                                   ctx_tokens=ctx_tokens, mode="prefill",
                                   caches=caches)
        return logits[:, -1], caches

    return prefill


def make_serve_step(cfg, sctx: ShardCtx = ShardCtx(), *, device=None):
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve(params, caches, tokens, pos: int):
        """tokens: (B,1) previous token; pos: its absolute position (an
        int). Writes the caches in place; returns (next token (B,1) int32
        on the device, caches)."""
        _check_params(params, dev)
        tokens = _on(tokens, dev).long()
        logits, caches = T.forward(cfg, params, tokens, sctx, mode="decode",
                                   caches=caches, pos=int(pos))
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return serve


@torch.inference_mode()
def generate(cfg, params, prompt, steps: int, sctx: ShardCtx = ShardCtx(), *,
             max_len: Optional[int] = None, ctx_tokens=None, enc_embeds=None,
             device=None):
    """Greedy generation: ``steps`` tokens (B, steps) int32 on the device."""
    max_len = max_len or (prompt.shape[1] + steps + cfg.meta_tokens)
    prefill = make_prefill_step(
        cfg, sctx, max_len=max_len, device=device,
        n_ctx=0 if ctx_tokens is None and enc_embeds is None else
        (ctx_tokens.shape[1] if ctx_tokens is not None else enc_embeds.shape[1]))
    serve = make_serve_step(cfg, sctx, device=device)
    logits, caches = prefill(params, prompt, ctx_tokens=ctx_tokens,
                             enc_embeds=enc_embeds)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    pos = prompt.shape[1] + cfg.meta_tokens
    for i in range(steps - 1):
        tok, caches = serve(params, caches, tok, pos + i)
        out.append(tok)
    return torch.cat(out, dim=1)
