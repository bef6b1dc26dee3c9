"""Parameter-spec system: one source of truth for shapes, logical axes, init.

``param_specs(cfg)`` returns a tree (nested dicts and lists) of ``P`` leaves
(shape + logical axis names + init scale), the reference's tree name for
name. It materializes two ways here:
  - ``init_params``     -> random tensors from a ``torch.Generator``
  - ``params_from_jax`` -> the reference's ``init_params`` output (as numpy
                           arrays) carried across, name for name
Scanned layer groups get a leading 'layers' axis. The reference's
``shardings`` and ``abstract_params`` (NamedSharding trees) come with the
port of ``distributed/*``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.common import torch_dtype
from repro_torch.models.config import ArchConfig, LayerSpec


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf spec."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | decay
    scale: float = 1.0

    def stacked(self, n: int) -> "P":
        return P((n,) + self.shape, ("layers",) + self.axes, self.init, self.scale)


def _attn_specs(cfg: ArchConfig, cross: bool = False):
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.heads_padded, cfg.kv_padded
    kv_ax = "heads" if cfg.kv_sharded else None
    s = {
        "wq": P((d, h, hd), ("embed", "heads", None), scale=d**-0.5),
        "wk": P((d, kv, hd), ("embed", kv_ax, None), scale=d**-0.5),
        "wv": P((d, kv, hd), ("embed", kv_ax, None), scale=d**-0.5),
        "wo": P((h, hd, d), ("heads", None, "embed"), scale=(h * hd) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = P((h, hd), ("heads", None), init="zeros")
        s["bk"] = P((kv, hd), (kv_ax, None), init="zeros")
        s["bv"] = P((kv, hd), (kv_ax, None), init="zeros")
    if cross:
        s["gate"] = P((), (), init="zeros")  # gated cross-attn (llama-3.2-v)
    return s


def _ffn_specs(cfg: ArchConfig, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act in ("silu", "gelu"):
        return {
            "wg": P((d, f), ("embed", "ffn"), scale=d**-0.5),
            "wu": P((d, f), ("embed", "ffn"), scale=d**-0.5),
            "wd": P((f, d), ("ffn", "embed"), scale=f**-0.5),
        }
    return {
        "wi": P((d, f), ("embed", "ffn"), scale=d**-0.5),
        "wd": P((f, d), ("ffn", "embed"), scale=f**-0.5),
    }


def _moe_specs(cfg: ArchConfig):
    m = cfg.moe
    d, fe = cfg.d_model, cfg.d_ff_e
    e = m.n_experts
    s = {
        "router": P((d, e), ("embed", None), scale=d**-0.5),
        "we_g": P((e, d, fe), ("experts", "embed", None), scale=d**-0.5),
        "we_u": P((e, d, fe), ("experts", "embed", None), scale=d**-0.5),
        "we_d": P((e, fe, d), ("experts", None, "embed"), scale=fe**-0.5),
    }
    if m.shared_expert:
        s["shared"] = _ffn_specs(cfg)
    if m.dense_residual:
        s["dense"] = _ffn_specs(cfg)
    return s


def _rwkv_specs(cfg: ArchConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner or d
    h = di // cfg.head_dim
    return {
        "mu": P((5, d), (None, None), init="ones", scale=0.5),  # token-shift mix
        "wr": P((d, h, cfg.head_dim), ("ffn", None, None), scale=d**-0.5),
        "wk": P((d, h, cfg.head_dim), ("ffn", None, None), scale=d**-0.5),
        "wv": P((d, h, cfg.head_dim), ("ffn", None, None), scale=d**-0.5),
        "wg": P((d, h, cfg.head_dim), ("ffn", None, None), scale=d**-0.5),
        "dec_a": P((d, s.dec_lora), ("ffn", None), scale=d**-0.5),
        "dec_b": P((s.dec_lora, h, cfg.head_dim), (None, None, None), scale=0.1),
        "dec_lambda": P((h, cfg.head_dim), (None, None), init="decay"),
        "bonus": P((h, cfg.head_dim), (None, None), scale=0.1),
        "wo": P((h, cfg.head_dim, d), (None, "ffn", None), scale=di**-0.5),
        # channel-mix (rwkv FFN) lives in the regular ffn slot
    }


def _mamba_specs(cfg: ArchConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner or d
    return {
        "w_in": P((d, di), ("embed", "ffn"), scale=d**-0.5),
        "w_z": P((d, di), ("embed", "ffn"), scale=d**-0.5),
        "w_b": P((d, s.state), ("embed", None), scale=d**-0.5),
        "w_c": P((d, s.state), ("embed", None), scale=d**-0.5),
        "w_dt": P((d, di), ("embed", "ffn"), scale=d**-0.5),
        "dt_bias": P((di,), ("ffn",), init="ones", scale=0.01),
        "a_log": P((di,), ("ffn",), init="decay"),
        "conv": P((s.conv, di), (None, "ffn"), scale=s.conv**-0.5),
        "w_out": P((di, d), ("ffn", "embed"), scale=di**-0.5),
        "norm_b": P((di,), ("ffn",), init="ones"),
    }


def _layer_specs(cfg: ArchConfig, spec: LayerSpec):
    s = {"ln1": P((cfg.d_model,), ("embed",), init="ones")}
    if spec.attn != "none":
        s["attn"] = _attn_specs(cfg)
    if spec.cross:
        s["xattn"] = _attn_specs(cfg, cross=True)
        s["ln_x"] = P((cfg.d_model,), ("embed",), init="ones")
    if spec.ssm:
        kind = cfg.ssm.kind
        s["ssm"] = _rwkv_specs(cfg) if kind == "rwkv6" else _mamba_specs(cfg)
        if spec.attn != "none":  # hymba: fusion scalars for the two branches
            s["fuse_a"] = P((), (), init="ones")
            s["fuse_s"] = P((), (), init="ones")
    s["ln2"] = P((cfg.d_model,), ("embed",), init="ones")
    s["ffn" if not spec.moe else "moe"] = (
        _moe_specs(cfg) if spec.moe else _ffn_specs(cfg)
    )
    if cfg.post_norm:
        s["ln1b"] = P((cfg.d_model,), ("embed",), init="ones")
        s["ln2b"] = P((cfg.d_model,), ("embed",), init="ones")
    return s


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists (order kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """``(path, leaf)`` pairs of a tree, paths joined by '.'."""
    out = []
    tree_map(out.append, _paths(tree))
    return out


def _paths(tree, prefix: str = ""):
    """The tree with every leaf replaced by ``(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return (prefix, tree)


def _stack_group(cfg: ArchConfig, unit, repeat: int):
    unit_specs = {f"sub{i}": _layer_specs(cfg, sp) for i, sp in enumerate(unit)}
    if repeat == 1:
        return unit_specs
    return tree_map(lambda p: p.stacked(repeat), unit_specs)


def vocab_padded(cfg: ArchConfig) -> int:
    """Vocab rounded up to a tp multiple (seamless 256206, hymba 32001 need
    padding at tp=16); padded logits are masked in transformer.unembed."""
    return -(-cfg.vocab // cfg.tp) * cfg.tp


def param_specs(cfg: ArchConfig):
    d, v = cfg.d_model, vocab_padded(cfg)
    tree = {
        "embed": P((v, d), ("vocab", "embed"), scale=1.0),
        "ln_f": P((d,), ("embed",), init="ones"),
        "groups": [
            _stack_group(cfg, unit, r) for unit, r in cfg.layer_plan()
        ],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = P((d, v), ("embed", "vocab"), scale=d**-0.5)
    if cfg.meta_tokens:
        tree["meta"] = P((cfg.meta_tokens, d), (None, "embed"), scale=0.02)
    if cfg.cross_attn:  # vlm: projection stub for precomputed patch embeddings
        tree["ctx_proj"] = P((d, d), (None, "embed"), scale=d**-0.5)
    if cfg.enc_dec:
        tree["enc_groups"] = [
            _stack_group(cfg, unit, r) for unit, r in cfg.encoder_plan()
        ]
        tree["dec_groups"] = [
            _stack_group(cfg, unit, r) for unit, r in cfg.decoder_plan()
        ]
        tree["ln_enc"] = P((d,), ("embed",), init="ones")
        tree.pop("groups")
    return tree


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device=None):
    """Random parameters with the reference's shapes, scales and init kinds.

    Normal leaves are drawn in float32 from ``generator`` (on its own
    device), scaled, cast to ``cfg.param_dtype`` and moved to ``device``
    (the card unless ``device="cpu"``). The stream is torch's, not
    ``jax.random``'s: ``params_from_jax`` carries the reference's weights.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return (torch.ones(p.shape, device=dev) * p.scale).to(dtype)
        if p.init == "decay":
            span = np.linspace(-6.0, -1.0, int(np.prod(p.shape)) or 1)
            return torch.as_tensor(span.reshape(p.shape), dtype=dtype,
                                   device=dev)
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * p.scale).to(dtype).to(dev)

    return tree_map(make, param_specs(cfg))


def params_from_jax(cfg: ArchConfig, tree, *, device=None):
    """The reference's ``init_params(cfg, key)`` output, its leaves as numpy
    arrays, as the port's parameters: name for name and shape for shape
    (stacked groups keep their leading ``layers`` axis), in
    ``cfg.param_dtype`` on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    got = dict(tree_leaves(tree))

    def carry(leaf):
        path, p = leaf
        if path not in got:
            raise KeyError(f"parameter {path!r} missing from the tree")
        a = np.asarray(got.pop(path))
        if a.shape != p.shape:
            raise ValueError(f"parameter {path!r}: shape {a.shape}, "
                             f"expected {p.shape}")
        if a.dtype.name == "bfloat16":  # numpy-side bfloat16: widen exactly
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dtype=dtype, device=dev)

    out = tree_map(carry, _paths(param_specs(cfg)))
    if got:
        raise KeyError(f"parameters not in the config's tree: {sorted(got)}")
    return out


def count_params(cfg: ArchConfig) -> int:
    total = 0
    for _, p in tree_leaves(param_specs(cfg)):
        total += int(np.prod(p.shape)) if p.shape else 1
    return total


def opt_state_from_jax(cfg: ArchConfig, state, *, device=None):
    """The reference's optimizer state for ``cfg``'s parameters (``adamw``:
    ``{"m", "v", "step"}``; ``adafactor``: ``{"v": {... {"vr", "vc"} |
    {"v"}}, "step"}``), its leaves as numpy arrays, as the port's: float32
    tensors on ``device`` (the card unless ``device="cpu"``) in the
    parameters' tree layout, leaf for leaf, and ``step`` an int32 0-dim
    tensor."""
    dev = resolve_device(device)
    specs = _paths(param_specs(cfg))

    def carry(a, shape, path):
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(f"optimizer state {path!r}: shape {a.shape}, "
                             f"expected {tuple(shape)}")
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    def moment(tree):
        got = dict(tree_leaves(tree))

        def one(leaf):
            path, p = leaf
            return carry(got.pop(path), p.shape, path)

        out = tree_map(one, specs)
        if got:
            raise KeyError(f"state leaves not in the config's tree: "
                           f"{sorted(got)}")
        return out

    def factored(tree):
        got = dict(tree_leaves(tree))

        def one(leaf):
            path, p = leaf
            if len(p.shape) >= 2:
                return {"vr": carry(got.pop(f"{path}.vr"), p.shape[:-1], path),
                        "vc": carry(got.pop(f"{path}.vc"),
                                    p.shape[:-2] + p.shape[-1:], path)}
            return {"v": carry(got.pop(f"{path}.v"), p.shape, path)}

        out = tree_map(one, specs)
        if got:
            raise KeyError(f"state leaves not in the config's tree: "
                           f"{sorted(got)}")
        return out

    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    if "m" in state:  # adamw
        return {"m": moment(state["m"]), "v": moment(state["v"]),
                "step": step}
    return {"v": factored(state["v"]), "step": step}
