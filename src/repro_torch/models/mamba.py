"""Selective SSM (Mamba-2/SSD-style scalar-decay-per-channel) for Hymba.

State: h (B, D_inner, N_state); per step
    h_t = exp(dt_t * A)[d] * h_{t-1} + dt_t * x_t ⊗ B_t,   y_t = h_t · C_t
Chunked like rwkv.py (a Python loop over chunks of CHUNK steps): log-decays
accumulated from the chunk start so all pairwise ratios are <= 1; the
intra-chunk term is a (C, C) matmul over the state dim plus a per-channel
decay-ratio weighting, the (B, C, C, D) ratio tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16
LW_MIN = -8.0


def _proj(cfg, p, x):
    xf = x.float()
    xi = xf @ p["w_in"].float()
    z = xf @ p["w_z"].float()
    bmat = xf @ p["w_b"].float()
    cmat = xf @ p["w_c"].float()
    dt = F.softplus(xf @ p["w_dt"].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # (D,) scalar decay per channel
    lw = torch.clamp(dt * a, LW_MIN, -1e-6)  # (B,S,D)
    return xi, z, bmat, cmat, dt, lw


def _chunk_step(h, uu, bb, cc, ll):
    """One chunk of the SSD-style scan. h: (B,D,N); uu, ll (B,C,D); bb, cc
    (B,C,N)."""
    cum = torch.cumsum(ll, dim=1)  # (B,C,D)
    # inter-chunk: y_t = C_t · (exp(cum_t) ⊙_D h)
    y_inter = torch.einsum("bcn,bcd,bdn->bcd", cc, torch.exp(cum), h)
    # intra-chunk: y[t,d] = sum_{tau<=t} (C_t·B_tau) exp(cum_t-cum_tau)[d] u[tau,d]
    cb = torch.einsum("bcn,btn->bct", cc, bb)  # (B,C,C)
    c_len = uu.shape[1]
    tri = torch.tril(torch.ones((c_len, c_len), dtype=torch.bool,
                                device=uu.device))
    cb = torch.where(tri[None], cb, 0.0)
    ratio = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,C,C,D) <=1
    ratio = torch.where(tri[None, :, :, None], ratio, 0.0)
    y_intra = torch.einsum("bct,bctd,btd->bcd", cb, ratio, uu)
    # state update
    decay_end = torch.exp(cum[:, -1])  # (B,D)
    tail = torch.exp(cum[:, -1:, :] - cum)  # (B,C,D)
    h = decay_end[..., None] * h + torch.einsum("bcd,bcn->bdn", uu * tail, bb)
    return h, y_inter + y_intra


def _conv_mix(p, xi, conv_state=None):
    """Depthwise causal conv over time. xi: (B,S,D). Returns (out, new_state)."""
    w = p["conv"].float()  # (K, D)
    k = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((xi.shape[0], k - 1, xi.shape[2]),
                                 dtype=torch.float32, device=xi.device)
    ext = torch.cat([conv_state, xi], dim=1)
    out = sum(ext[:, i: i + xi.shape[1]] * w[i] for i in range(k))
    return F.silu(out), ext[:, -(k - 1):, :]


def mamba_mix(cfg, p, x, conv_state=None, h=None):
    """Full-sequence selective SSM. x: (B,S,d). Returns (out, (conv_state, h))."""
    b, s, d = x.shape
    di = cfg.ssm.d_inner or d
    xi, z, bmat, cmat, dt, lw = _proj(cfg, p, x)
    xi, conv_state = _conv_mix(p, xi, conv_state)
    if h is None:
        h = torch.zeros((b, di, cfg.ssm.state), dtype=torch.float32,
                        device=x.device)

    # Padded steps get u=0 and lw=0: the state passes through intact.
    pad = (-s) % CHUNK
    u, bm, cm, lwp = (F.pad(t, (0, 0, 0, pad))
                      for t in (xi * dt, bmat, cmat, lw))
    ys = []
    for c0 in range(0, s + pad, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        h, y = _chunk_step(h, u[:, sl], bm[:, sl], cm[:, sl], lwp[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y * F.silu(z)
    y = y * p["norm_b"].float()
    out = y @ p["w_out"].float()
    return out.to(x.dtype), (conv_state, h)


def mamba_decode(cfg, p, x, conv_state, h):
    """One-token recurrence. x: (B,1,d)."""
    xi, z, bmat, cmat, dt, lw = _proj(cfg, p, x)
    xi, conv_state = _conv_mix(p, xi, conv_state)
    u1 = (xi * dt)[:, 0]  # (B,D)
    h = torch.exp(lw[:, 0])[..., None] * h + torch.einsum(
        "bd,bn->bdn", u1, bmat[:, 0])
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
    y = y * F.silu(z) * p["norm_b"].float()
    out = y @ p["w_out"].float()
    return out.to(x.dtype), (conv_state, h)


def mamba_mix_ref(cfg, p, x):
    """Sequential oracle for tests."""
    b, s, d = x.shape
    di = cfg.ssm.d_inner or d
    conv_state = torch.zeros((b, cfg.ssm.conv - 1, di), dtype=torch.float32,
                             device=x.device)
    h = torch.zeros((b, di, cfg.ssm.state), dtype=torch.float32,
                    device=x.device)
    outs = []
    for t in range(s):
        o, (conv_state, h) = mamba_decode(cfg, p, x[:, t: t + 1], conv_state, h)
        outs.append(o)
    return torch.cat(outs, dim=1)
