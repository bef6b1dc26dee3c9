"""Model assembly: layer dispatch, layer groups, prefill/decode caches,
forward, and the ``Decoder`` module that owns the parameters.

One generic stack serves all 10 assigned architectures; the per-layer
``LayerSpec`` chooses the sequence mixer (global/local attention, RWKV6,
Mamba branch, cross-attention) and FFN (dense / MoE). A layer group with
``repeat > 1`` holds its parameters and caches stacked on a leading layer
axis, and the port loops over that axis (the reference scans it).

Caches are written in place: every layer of a stacked group has storage of
its own (``init_cache`` allocates ``(repeat, ...)`` tensors, never a
broadcast view), and a layer updates its slot through a view of it.

In "train" mode under autograd each unit of a group (one layer index: its
sub-layers together) runs under ``torch.utils.checkpoint``: its
activations are recomputed in the backward, the reference's per-layer
``jax.checkpoint``. ``remat=False`` keeps them instead.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models.common import ShardCtx, rms_norm, softcap, torch_dtype
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.params import tree_map


def _branch_norm(x, eps=1e-6):
    return x * torch.rsqrt(torch.mean(torch.square(x.float()), -1,
                                      keepdim=True) + eps).to(x.dtype)


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, n_ctx: int = 0, *, device, lead=()):
    """Decode cache slots for one layer (``lead``: the group's layer axis)."""
    dt = torch_dtype(cfg.compute_dtype)
    f32 = torch.float32
    lead = tuple(lead)

    def zeros(*shape, dtype=dt):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    c = {}
    if spec.attn != "none":
        window = cfg.window if spec.attn == "local" else 0
        c["attn"] = A.init_attn_cache(cfg, batch, max_len, window, dtype=dt,
                                      device=device, lead=lead)
    if spec.cross:
        kv = cfg.kv_padded
        c["xk"] = zeros(batch, n_ctx, kv, cfg.head_dim)
        c["xv"] = zeros(batch, n_ctx, kv, cfg.head_dim)
    if spec.ssm:
        d = cfg.d_model
        di = cfg.ssm.d_inner or d
        if cfg.ssm.kind == "rwkv6":
            h = di // cfg.head_dim
            c["ssm"] = {
                "x_prev": zeros(batch, d, dtype=f32),
                "state": zeros(batch, h, cfg.head_dim, cfg.head_dim, dtype=f32),
            }
        else:
            c["ssm"] = {
                "conv": zeros(batch, cfg.ssm.conv - 1, di, dtype=f32),
                "h": zeros(batch, di, cfg.ssm.state, dtype=f32),
            }
    return c


def layer_fwd(cfg: ArchConfig, spec: LayerSpec, p, x, positions,
              sctx: ShardCtx = ShardCtx(), *, mode: str = "train", cache=None,
              pos=None, ctx_tokens=None):
    """One transformer layer. Returns x; in "prefill" and "decode" modes it
    writes the layer's ``cache`` in place."""
    p = sctx.use_weights(p)  # ZeRO-3: gather stored shards at use
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixed = None

    if spec.attn != "none":
        window = cfg.window if spec.attn == "local" else 0
        if mode == "decode":
            mixed, _ = A.decode_attention(cfg, p["attn"], h, cache["attn"],
                                          pos, window=window)
        else:
            mixed, (k, v) = A.self_attention(
                cfg, p["attn"], h, positions, causal=spec.causal, window=window
            )
            if mode == "prefill":
                A.prefill_attn_cache(cache["attn"], k, v, positions)

    if spec.ssm:
        if cfg.ssm.kind == "rwkv6":
            if mode == "decode":
                ssm_out, new = R.rwkv6_decode(
                    cfg, p["ssm"], h, cache["ssm"]["x_prev"], cache["ssm"]["state"]
                )
            else:
                ssm_out, new = R.rwkv6_mix(cfg, p["ssm"], h)
            names = ("x_prev", "state")
        else:
            if mode == "decode":
                ssm_out, new = M.mamba_decode(
                    cfg, p["ssm"], h, cache["ssm"]["conv"], cache["ssm"]["h"]
                )
            else:
                ssm_out, new = M.mamba_mix(cfg, p["ssm"], h)
            names = ("conv", "h")
        if mode in ("decode", "prefill"):
            for name, t in zip(names, new):
                cache["ssm"][name].copy_(t)
        if mixed is None:
            mixed = ssm_out
        else:  # hymba: normalized fusion of the two branches
            mixed = (
                p["fuse_a"].to(mixed.dtype) * _branch_norm(mixed)
                + p["fuse_s"].to(mixed.dtype) * _branch_norm(ssm_out)
            ) * 0.5

    if cfg.post_norm:
        mixed = rms_norm(mixed, p["ln1b"], cfg.norm_eps)
    x = x + mixed

    if spec.cross:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            kv = (cache["xk"], cache["xv"])
        else:
            kv = A.ctx_kv(cfg, p["xattn"], ctx_tokens)
            if mode == "prefill":
                cache["xk"].copy_(kv[0])
                cache["xv"].copy_(kv[1])
        x = x + A.cross_attention(cfg, p["xattn"], hx, kv)

    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.moe:
        ffn_out = F.moe_ffn(cfg, p["moe"], h2, sctx)
    else:
        ffn_out = F.dense_ffn(cfg, p["ffn"], h2)
    if cfg.post_norm:
        ffn_out = rms_norm(ffn_out, p["ln2b"], cfg.norm_eps)
    return x + ffn_out


def _layer(tree, i):
    """Layer ``i`` of a stacked group's tree (views, sharing storage)."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n):
    """A stacked group's tree as ``n`` per-layer trees of views, from one
    ``unbind`` a leaf: under autograd its backward stacks the layers'
    gradients once, where a select a layer would give each layer a
    gradient of the whole stacked leaf, zeros but its slice, and add the
    ``n`` of them."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def _unit_fwd(cfg, unit, lp, x, positions, sctx, *, mode, lc, pos,
              ctx_tokens):
    for i, spec in enumerate(unit):
        x = layer_fwd(cfg, spec, lp[f"sub{i}"], x, positions, sctx, mode=mode,
                      cache=lc[f"sub{i}"] if lc else None, pos=pos,
                      ctx_tokens=ctx_tokens)
    return x


def groups_fwd(cfg, groups_params, plan, x, positions,
               sctx: ShardCtx = ShardCtx(), *, mode="train", caches=None,
               pos=None, ctx_tokens=None, remat=True):
    """Run all layer groups, layer by layer over each group's stacked axis.
    Returns x; caches, when given, are written in place. In "train" mode
    under autograd with ``remat``, each unit is recomputed in the
    backward."""
    recompute = remat and mode == "train" and torch.is_grad_enabled()
    for gi, ((unit, repeat), gp) in enumerate(zip(plan, groups_params)):
        cache_g = caches[gi] if caches is not None else None
        layers = [gp] if repeat == 1 else _unstack(gp, repeat)
        for li in range(repeat):
            lp = layers[li]
            lc = cache_g if repeat == 1 or cache_g is None \
                else _layer(cache_g, li)
            kw = dict(mode=mode, lc=lc, pos=pos, ctx_tokens=ctx_tokens)
            if recompute:  # no RNG in a layer: no RNG state to keep
                x = torch.utils.checkpoint.checkpoint(
                    _unit_fwd, cfg, unit, lp, x, positions, sctx, **kw,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x = _unit_fwd(cfg, unit, lp, x, positions, sctx, **kw)
    return x


def init_cache(cfg: ArchConfig, plan, batch: int, max_len: int,
               n_ctx: int = 0, *, device):
    """One cache per group; a group of ``repeat > 1`` layers gets real
    ``(repeat, ...)`` tensors, one slice per layer."""
    return [
        {f"sub{i}": init_layer_cache(cfg, spec, batch, max_len, n_ctx,
                                     device=device,
                                     lead=(repeat,) if repeat > 1 else ())
         for i, spec in enumerate(unit)}
        for unit, repeat in plan
    ]


# ---------------------------------------------------------------- full model
def embed_tokens(cfg, params, tokens):
    dt = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(dt)
    # The scale rounded to the compute dtype first, as the reference does.
    return x * torch.full((), cfg.d_model**0.5, dtype=dt, device=x.device)


def unembed(cfg, params, x):
    table = params.get("unembed")
    if table is None:
        logits = x @ params["embed"].T
    else:
        logits = x @ table
    logits = softcap(logits.float(), cfg.final_softcap)
    if logits.shape[-1] != cfg.vocab:  # mask padding columns (params.vocab_padded)
        logits[..., cfg.vocab:] = -1e30
    return logits


def _dec(cfg, params):
    if cfg.enc_dec:
        return cfg.decoder_plan(), params["dec_groups"]
    return cfg.layer_plan(), params["groups"]


def forward(cfg: ArchConfig, params, tokens, sctx: ShardCtx = ShardCtx(), *,
            ctx_tokens=None, mode="train", caches=None, pos=None,
            remat=True):
    """Decoder forward. tokens: (B,S) integer tensor (decode: (B,1), with
    ``pos`` the absolute position, an int).

    ctx_tokens: VLM patch embeddings (B,N,d) or enc-dec encoder output.
    Returns (logits, caches): in "prefill" and "decode" modes ``caches``
    (from ``init_cache``) are written in place and returned. ``remat``:
    recompute each layer in the backward ("train" mode under autograd).
    ``sctx``: a mesh runs the MoE layers expert-parallel; with
    ``gather_weights``, sharded parameters are gathered at use.
    """
    if sctx.gather_weights:  # ZeRO-3: embed/head shards gathered at use too
        top = {k: v for k, v in params.items()
               if k not in ("groups", "enc_groups", "dec_groups")}
        params = {**params, **sctx.use_weights(top)}
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    if cfg.meta_tokens and mode != "decode":
        meta = params["meta"].to(x.dtype)[None].expand(
            b, cfg.meta_tokens, x.shape[-1])
        x = torch.cat([meta, x], dim=1)
        s = s + cfg.meta_tokens
    if ctx_tokens is not None and "ctx_proj" in params:
        ctx_tokens = ctx_tokens.to(x.dtype) @ params["ctx_proj"]
    plan, groups = _dec(cfg, params)
    positions = None
    if mode != "decode":
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = groups_fwd(cfg, groups, plan, x, positions, sctx, mode=mode,
                   caches=caches, pos=pos, ctx_tokens=ctx_tokens, remat=remat)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.meta_tokens and mode != "decode":
        x = x[:, cfg.meta_tokens:]
    return unembed(cfg, params, x), caches


def encode(cfg: ArchConfig, params, enc_embeds, sctx: ShardCtx = ShardCtx(),
           *, remat=True):
    """Enc-dec encoder over precomputed frame embeddings (B,S,d)."""
    b, s, _ = enc_embeds.shape
    positions = torch.arange(s, device=enc_embeds.device)[None].expand(b, s)
    x = enc_embeds.to(torch_dtype(cfg.compute_dtype))
    x = groups_fwd(cfg, params["enc_groups"], cfg.encoder_plan(), x,
                   positions, sctx, mode="train", remat=remat)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


# ------------------------------------------------------------------ module
class _Tree(nn.Module):
    """A parameter tree as modules: a dict's tensors are parameters, its
    dicts submodules, its lists ``ModuleList``s, so ``state_dict`` keys are
    the tree's paths joined by '.'."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(_Tree(g) for g in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self):
        """The parameters as the tree the layer functions take (the
        module's own tensors, no copy)."""
        out = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = [g.tree() for g in m] if isinstance(m, nn.ModuleList) \
                else m.tree()
        return out


class Decoder(_Tree):
    """The model as an ``nn.Module``: it owns ``params`` (from
    ``init_params`` or ``params_from_jax``) as registered tensors, so
    ``.to(device)`` moves all of them and ``state_dict`` keys are the
    reference tree's paths (``groups.0.sub0.attn.wq``)."""

    def __init__(self, cfg: ArchConfig, params):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens, **kw):
        return forward(self.cfg, self.tree(), tokens, **kw)
