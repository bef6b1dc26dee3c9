"""Shared model building blocks: norms, activations, RoPE, softcap, context."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              ShardedTensor, device_get,
                                              report_collective, tree_map)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Runtime distribution context threaded through model forward passes.

    When ``mesh`` (a ``repro_torch.aqp.executor.Mesh``) is set, MoE layers
    run expert-parallel over ``model_axis`` with their tokens split over
    ``batch_axes`` (``ffn.moe_ffn``). When None (smoke tests / single
    device), everything runs on the inputs' device. The placement is one
    process's: a sharding constraint changes no value, so ``constrain``
    only checks its spec against the mesh.
    """

    mesh: object = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # ZeRO-3 semantics: layer weights are *stored* fully sharded
    # (``ShardedTensor`` leaves from ``distributed.sharding.device_put``)
    # and gathered at use, onto the mesh's first device, where the layer's
    # dense compute runs.
    gather_weights: bool = False

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def use_weights(self, p):
        if not (self.enabled and self.gather_weights):
            return p
        home = self.mesh.devices[0]

        def gather(w):
            if not isinstance(w, ShardedTensor):
                return w
            out = device_get(w, home)
            if any(k > 1 for k in w.sharding.shard_counts(w.ndim)):
                report_collective("all-gather", out)
            return out

        return tree_map(gather, p)

    def constrain(self, x, *spec):
        if self.enabled:
            NamedSharding(self.mesh, PartitionSpec(*spec))
        return x

    def batch_spec(self):
        return self.batch_axes if self.enabled else None


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
