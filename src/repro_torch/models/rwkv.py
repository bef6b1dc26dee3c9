"""RWKV-6 ("Finch") time-mix: linear attention with data-dependent decay.

Chunked formulation (the reference's): within a chunk of length C the
per-channel decays are accumulated in log space from the chunk start, so
every pairwise decay ratio exp(cum[t-1] - cum[tau]) with tau <= t-1 is <= 1
— no overflow; the intra-chunk term is a (C, C) masked matmul and the
inter-chunk state is carried as (B, H, K, V) float32, a Python loop over
the chunks. Log-decays are clipped at LW_MIN; contributions beyond the clip
are < e^{-CHUNK·|LW_MIN|} ≈ 0.

As in the reference, the data-dependent *decay* (the Finch contribution)
is kept; the data-dependent token-shift LoRA is replaced by static learned
mix coefficients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16
LW_MIN = -8.0


def _heads(cfg, d):
    return (cfg.ssm.d_inner or d) // cfg.head_dim


def _projections(cfg, p, x, x_prev):
    """Token-shift mix + r/k/v/g/w projections. x: (B,S,d) f32."""
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mu = p["mu"].float()  # (5, d)
    xs = [x + mu[i] * (shifted - x) for i in range(5)]  # r,k,v,g,w views

    def proj(xi, w):
        return torch.einsum("bsd,dhk->bshk", xi, w.float())

    r = proj(xs[0], p["wr"])
    k = proj(xs[1], p["wk"])
    v = proj(xs[2], p["wv"])
    g = proj(xs[3], p["wg"])
    # data-dependent decay (LoRA): lw = -exp(lambda + tanh(x A) B)
    lora = torch.einsum(
        "bsr,rhk->bshk",
        torch.tanh(torch.einsum("bsd,dr->bsr", xs[4], p["dec_a"].float())),
        p["dec_b"].float(),
    )
    lw = -torch.exp(p["dec_lambda"].float() + lora)
    lw = torch.clamp(lw, LW_MIN, -1e-6)  # log decay per (B,S,H,K)
    return r, k, v, g, lw


def _chunk_step(state, r, k, v, lw, u):
    """One chunk. state (B,H,K,V); r, k, v, lw each (B,C,H,K)."""
    cum = torch.cumsum(lw, dim=1)  # (B,C,H,K) log decay from chunk start
    # inter-chunk: y_t += (r_t ⊙ exp(cum_{t-1})) @ state
    q_dec = r * torch.exp(cum - lw)  # exp(cum_{t-1}) = exp(cum_t - lw_t)
    y_inter = torch.einsum("bchk,bhkv->bchv", q_dec, state)
    # intra-chunk: A[t,tau] = sum_k r_t exp(cum_{t-1}) * k_tau exp(-cum_tau), tau < t
    k_dec = k * torch.exp(-cum)
    att = torch.einsum("bchk,bdhk->bhcd", q_dec, k_dec)  # (B,H,C,C)
    c = r.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    att = torch.where(tri[None, None], att, 0.0)
    y_intra = torch.einsum("bhcd,bdhv->bchv", att, v)
    # bonus (current token) term: u ⊙ k_t
    y_bonus = torch.einsum("bchk,bchv->bchv", r * (u * k), v)
    # state update: S' = diag(exp(cum_C)) S + sum_tau exp(cum_C - cum_tau) k_tau v_tau^T
    decay_all = torch.exp(cum[:, -1:])  # (B,1,H,K)
    k_tail = k * torch.exp(cum[:, -1:] - cum)
    state = decay_all[:, 0][..., None] * state + torch.einsum(
        "bchk,bchv->bhkv", k_tail, v
    )
    return state, y_inter + y_intra + y_bonus


def rwkv6_mix(cfg, p, x, x_prev=None, state=None):
    """Full-sequence RWKV6 time-mix. x: (B,S,d). Returns (out, (x_last, state))."""
    b, s, d = x.shape
    h, hd = _heads(cfg, d), cfg.head_dim
    xf = x.float()
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    r, k, v, g, lw = _projections(cfg, p, xf, x_prev.float())
    u = p["bonus"].float()

    # Padded steps get lw=0 (decay=1) and k=v=0, leaving the state intact.
    pad = (-s) % CHUNK
    r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    ys = []
    for c0 in range(0, s + pad, CHUNK):
        state, y = _chunk_step(state, r[:, c0:c0 + CHUNK], k[:, c0:c0 + CHUNK],
                               v[:, c0:c0 + CHUNK], lw[:, c0:c0 + CHUNK], u)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y * F.silu(g)  # output gate
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"].float())
    return out.to(x.dtype), (xf[:, -1, :], state)


def rwkv6_decode(cfg, p, x, x_prev, state):
    """One-token recurrence. x: (B,1,d). Returns (out, (x_last, state))."""
    xf = x.float()
    r, k, v, g, lw = _projections(cfg, p, xf, x_prev.float())
    u = p["bonus"].float()
    r1, k1, v1, lw1 = (t[:, 0] for t in (r, k, v, lw))  # (B,H,K)
    y = torch.einsum("bhk,bhkv->bhv", r1, state) + torch.einsum(
        "bhk,bhv->bhv", r1 * (u * k1), v1
    )
    state = torch.exp(lw1)[..., None] * state + torch.einsum(
        "bhk,bhv->bhkv", k1, v1)
    y = (y * F.silu(g[:, 0]))[:, None]
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"].float())
    return out.to(x.dtype), (xf[:, -1, :], state)


def rwkv6_mix_ref(cfg, p, x):
    """Sequential-scan oracle for tests: step-by-step decode over the sequence."""
    b, s, d = x.shape
    h = _heads(cfg, d)
    x_prev = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    state = torch.zeros((b, h, cfg.head_dim, cfg.head_dim),
                        dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        o, (x_prev, state) = rwkv6_decode(cfg, p, x[:, t: t + 1], x_prev, state)
        outs.append(o)
    return torch.cat(outs, dim=1)
