"""Shared model building blocks: norms, activations, RoPE, softcap, context."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Runtime distribution context threaded through model forward passes.

    Single device only: the reference's mesh (expert-parallel MoE and
    activation sharding constraints) comes with the port of
    ``distributed/sharding.py``, so a ``mesh`` is refused rather than run
    on one device in silence.
    """

    mesh: object = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ShardCtx(mesh=...) is not ported: the mesh comes with the "
                "port of distributed/sharding.py; pass no mesh")


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def activate(act: str, g, u=None):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
    if act == "silu":
        return F.silu(g) * u
    if act == "gelu":
        return F.gelu(g, approximate="tanh") * u
    return F.gelu(g, approximate="tanh")  # gelu_mlp (non-gated)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding over the last dim; x: (..., S, H, hd), positions
    (..., S). Computed in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = torch.pow(theta, -freqs)  # (half,)
    ang = positions.float()[..., None, None] * inv  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype`` / ``compute_dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt
