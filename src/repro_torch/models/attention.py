"""GQA attention with RoPE, logit softcap, sliding windows, cross-attention,
and a ring-buffered KV cache for decode.

Head layout: projections carry (heads, head_dim) explicitly, as in the
reference; configs whose head counts need padding are padded at spec-build
time (see ArchConfig.heads_padded).

The KV cache is written in place (``index_copy_`` / slice assignment on
the cache's own storage): ``prefill_attn_cache`` and ``decode_attention``
return the cache they were given, updated.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import rope, softcap

NEG = -2.0e38


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product."""
    b, s, h, hd = out.shape
    return (out.reshape(b * s, h * hd) @ wo.reshape(h * hd, -1)).reshape(
        b, s, -1)


def _project_qkv(cfg, p, x, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_to_out(cfg, q, k, v, mask):
    """q: (B,S,H,hd); k/v: (B,T,KV,hd); mask: (B,1,1,S,T) or broadcastable.

    The logits are a product in the compute dtype, then cast to float32,
    as the reference computes them.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = logits / (hd**0.5)
    logits = softcap(logits, cfg.attn_softcap)
    logits = torch.where(mask, logits, NEG)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, h, hd)


def self_attention(cfg, p, x, positions, *, causal=True, window=0):
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    qp = positions[:, :, None]  # (B,S,1)
    kp = positions[:, None, :]  # (B,1,T)
    mask = torch.ones_like(qp - kp, dtype=torch.bool)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    mask = mask[:, None, None]  # (B,1,1,S,T)
    out = _scores_to_out(cfg, q, k, v, mask)
    return _out_proj(out, p["wo"]), (k, v)


def cross_attention(cfg, p, x, ctx_kv, *, gated=True):
    """x: (B,S,d); ctx_kv: precomputed (k, v) of ctx tokens (B,N,KV,hd)."""
    q = _proj(x, p["wq"])  # no RoPE on cross-attn
    k, v = ctx_kv
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
    out = _out_proj(_scores_to_out(cfg, q, k, v, mask), p["wo"])
    if gated and "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def ctx_kv(cfg, p, ctx):
    """Project context tokens to (k, v) once (prefill-time)."""
    return _proj(ctx, p["wk"]), _proj(ctx, p["wv"])


def init_attn_cache(cfg, batch: int, max_len: int, window: int = 0, *,
                    dtype, device, lead=()):
    """Ring KV cache; local layers bound the ring at ``window`` slots.
    ``lead``: leading layer axes, each layer with storage of its own."""
    slots = min(window, max_len) if window else max_len
    kv = cfg.kv_padded
    shape = tuple(lead) + (batch, slots, kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full(tuple(lead) + (slots,), -1, dtype=torch.int32,
                               device=device),
    }


def prefill_attn_cache(cache, k, v, positions):
    """Write a full prefix into the cache in place (prefix may exceed the
    ring: its last ``slots`` positions are kept)."""
    slots = cache["k"].shape[1]
    s = k.shape[1]
    start = max(s - slots, 0)
    pp = positions[0, start:]
    idx = pp % slots  # ring placement consistent with decode
    cache["k"].index_copy_(1, idx, k[:, start:])
    cache["v"].index_copy_(1, idx, v[:, start:])
    cache["slot_pos"].index_copy_(0, idx, pp.to(torch.int32))
    return cache


def decode_attention(cfg, p, x, cache, pos: int, *, window=0):
    """One-token decode: x (B,1,d), pos the absolute position (int).
    Writes slot ``pos % slots`` of the cache in place; returns (out, cache)."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    slots = cache["k"].shape[1]
    slot = pos % slots
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    sp = cache["slot_pos"]
    sp[slot] = pos
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid = valid & (pos - sp < window)
    mask = valid[None, None, None, None, :]  # (1,1,1,1,T)
    out = _scores_to_out(cfg, q, cache["k"], cache["v"], mask)
    return _out_proj(out, p["wo"]), cache
