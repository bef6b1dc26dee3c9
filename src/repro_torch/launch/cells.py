"""Dry-run cells: (arch x shape) -> step function + abstract sharded inputs,
the reference's ``repro.launch.cells``.

Shapes (assigned):
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill_step
  decode_32k   seq 32768,  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288, global_batch 1     -> serve_step; ONLY for
               sub-quadratic archs (rwkv6, hymba, gemma2).

Each cell also carries *probes*: one layer group's forward (and its vjp
when training), one microbatch's vjp, one SSM chunk body, each at the
cell's full shapes and shardings, with the trip count the reference
multiplies its cost by. The reference needs them because XLA's
``cost_analysis`` counts a scan body once (step + sum of multiplier x
probe, ``launch.roofline.combine_costs``). The port runs eagerly and counts
every layer and every microbatch as it runs, so a port cell's probes are
per-group costs (one layer group, one microbatch, one chunk), not a
correction to add to a whole-step count; their multipliers stay the
reference's, since they are trip counts.

Abstract values are ``distributed.sharding.ShapeDtypeStruct`` leaves with a
``NamedSharding`` over the cell's mesh. ``jax.eval_shape`` becomes a call on
tensors of the ``meta`` device (``call_args``), and ``jax.grad``
``torch.autograd.grad`` with respect to the same arguments. The port's
placement is one process's: a step or probe takes global tensors and runs
on the mesh's first device, so a production mesh of 256 or 512 positions
is the ``meta`` device listed once a position
(``launch.mesh.make_production_mesh(device="meta")``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba as MB
from repro_torch.models import params as PM
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.common import ShardCtx, torch_dtype
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.training.optimizer import adafactor, adamw
from repro_torch.training.train_loop import make_train_step, value_and_grad

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

LONG_OK = {"rwkv6-3b", "hymba-1.5b", "gemma2-2b"}

# >=100B MoE: Adafactor + bf16 params, the reference's choice (made for a
# TPU's memory), kept so the cells are its cells. On 256 H100 cards of 80
# GB, AdamW's float32 m and v would be 8 bytes a parameter: 14.9 GB a card
# for arctic-480b, 12.4 GB for llama4-maverick.
BIG_ARCHS = {"arctic-480b", "llama4-maverick-400b-a17b"}


def cell_list() -> List[Tuple[str, str]]:
    cells = []
    for arch in configs.names():
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue  # documented skip: no sub-quadratic attention path
            cells.append((arch, shape))
    return cells


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple  # abstract (ShapeDtypeStruct) args, sharded
    kwargs: dict
    donate: tuple
    probes: list  # [(label, multiplier, fn, abstract_args)]
    cfg: object
    meta: dict


def _sds(shape, dtype, sharding=None):
    return SH.ShapeDtypeStruct(shape, dtype, sharding)


def _named(mesh, *spec):
    return SH.NamedSharding(mesh, SH.PartitionSpec(*spec))


def _shard_abstract(tree, shard_tree):
    return SH.tree_map(lambda a, s: _sds(a.shape, a.dtype, s), tree,
                       shard_tree)


def _leaves(tree):
    out = []
    SH.tree_map(out.append, tree)
    return out


def _like(tree, leaves):
    it = iter(leaves)
    return SH.tree_map(lambda _: next(it), tree)


def abstract(tree):
    """The abstract values (shape and dtype, no sharding) of a tree of
    tensors."""
    return SH.tree_map(lambda t: _sds(t.shape, t.dtype), tree)


def materialize(tree, device="meta", generator=None):
    """Tensors for a tree of abstract values on ``device``: without
    storage on ``meta`` (``jax.eval_shape``'s inputs); elsewhere floating
    leaves drawn normal from ``generator`` (on ``device``) times 0.02,
    integer leaves positions (``arange`` over the last dim: a probe's only
    integer inputs are token and cache slot positions) and 0-dim integer
    leaves zeros."""
    dev = torch.device(device)

    def make(a):
        if dev.type == "meta":
            return torch.empty(a.shape, dtype=a.dtype, device=dev)
        if a.dtype.is_floating_point:
            x = torch.randn(a.shape, generator=generator, dtype=torch.float32,
                            device=dev)
            return x.mul_(0.02).to(a.dtype)
        if not a.shape:
            return torch.zeros((), dtype=a.dtype, device=dev)
        return torch.arange(a.shape[-1], device=dev).to(a.dtype) \
            .expand(a.shape).contiguous()

    return SH.tree_map(make, tree)


def call_args(args, device="meta", generator=None, pos: int = 0):
    """Concrete arguments of a step or probe from its abstract ``args``:
    each as ``materialize`` makes it, but a 0-dim integer argument (a
    decode position) the Python int ``pos``, as the port's decode step and
    decode probes take it."""
    def one(a):
        if isinstance(a, SH.ShapeDtypeStruct) and not a.shape \
                and not a.dtype.is_floating_point:
            return int(pos)
        return materialize(a, device, generator)

    return tuple(one(a) for a in args)


def device_bytes(tree) -> int:
    """Bytes one mesh position holds of a tree of sharded abstract values
    (``NamedSharding.shard_counts``; an uneven split rounds up, as JAX
    pads it)."""
    total = 0
    for a in _leaves(tree):
        counts = (a.sharding.shard_counts(len(a.shape)) if a.sharding
                  else (1,) * len(a.shape))
        n = math.prod(-(-d // k) for d, k in zip(a.shape, counts))
        total += n * a.dtype.itemsize
    return total


def _grad(fn, *args):
    """``jax.grad(fn, argnums=range(len(args)))(*args)``: the gradients of
    the scalar ``fn(*args)`` with respect to each argument (a tensor or a
    tree of them), by ``torch.autograd.grad`` on detached aliases; a leaf
    the value does not reach gets zeros, as JAX gives it."""
    alias = [_like(a, [t.detach().requires_grad_() for t in _leaves(a)])
             for a in args]
    flat = [t for a in alias for t in _leaves(a)]
    with torch.enable_grad():
        grads = torch.autograd.grad(fn(*alias), flat, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(flat, grads))
    return tuple(_like(a, [next(it) for _ in _leaves(a)]) for a in alias)


def _plans(cfg):
    """[(groups_key, plan, is_encoder)] covering the whole model."""
    if cfg.enc_dec:
        return [("dec_groups", cfg.decoder_plan(), False),
                ("enc_groups", cfg.encoder_plan(), True)]
    return [("groups", cfg.layer_plan(), False)]


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               rules: Optional[dict] = None, accum: Optional[int] = None,
               cache_seq_axis: Optional[str] = None) -> Cell:
    info = SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    tp = mesh.shape["model"]
    rules = dict(rules or SH.DEFAULT_RULES)
    b_ax = rules.pop("_batch_axes", None)
    pure_dp = b_ax is not None
    if pure_dp and multi_pod:
        b_ax = ("pod",) + tuple(b_ax)
    cfg = configs.get(arch).with_tp(1 if pure_dp else tp)
    if pure_dp and cfg.moe:
        raise ValueError("pure-DP rules are for dense archs (MoE needs EP)")
    b_ax = b_ax or SH.batch_axes(multi_pod)
    sctx = ShardCtx(mesh=mesh, batch_axes=b_ax, gather_weights=pure_dp)
    home = mesh.devices[0]
    pshard = PM.shardings(cfg, mesh, rules)
    aparams = _shard_abstract(PM.abstract_params(cfg), pshard)
    dshards = math.prod(mesh.shape[a] for a in b_ax)
    meta = {"tp": tp, "data_shards": dshards, "multi_pod": multi_pod,
            "rules": {k: str(v) for k, v in rules.items()},
            "seq": seq, "batch": batch,
            "n_params": cfg.n_params, "n_active_params": cfg.n_active_params}

    n_ctx = cfg.cross_attn.n_ctx if cfg.cross_attn else 0
    d = cfg.d_model
    cdt = torch_dtype(cfg.compute_dtype)
    s_tok = seq // 2 if cfg.enc_dec else seq  # enc-dec splits the budget
    enc_len = seq - s_tok if cfg.enc_dec else 0

    if kind == "train":
        accum = accum or max(batch // dshards, 1)
        micro = batch // accum
        meta.update(accum=accum, micro=micro)
        opt = adafactor() if arch in BIG_ARCHS else adamw()
        meta["optimizer"] = opt.name
        step = make_train_step(cfg, opt, sctx, accum=accum)
        tok_s = _named(mesh, None, b_ax, None)
        batch_tree = {
            "tokens": _sds((accum, micro, s_tok), torch.int32, tok_s),
            "labels": _sds((accum, micro, s_tok), torch.int32, tok_s),
        }
        if cfg.cross_attn:
            batch_tree["ctx"] = _sds((accum, micro, n_ctx, d), cdt,
                                     _named(mesh, None, b_ax, None, None))
        if cfg.enc_dec:
            batch_tree["enc"] = _sds((accum, micro, enc_len, d), cdt,
                                     _named(mesh, None, b_ax, None, None))
        astate = abstract(opt.init(materialize(aparams)))
        oshard = SH.opt_state_shardings(opt.name, pshard, astate)
        astate = _shard_abstract(astate, oshard)
        lr = _sds((), torch.float32, _named(mesh))
        args = (aparams, astate, batch_tree, lr)
        # Trip counts (the reference's correction algebra, see roofline.py):
        #   total = step + (accum-1) x microbatch + accum·(R-1) x layer
        #         + accum·R·(n_chunks-1) x ssm_chunk.
        probes = []
        if accum > 1:
            def micro_fwd_bwd(params, mb):
                return value_and_grad(cfg, params, mb, sctx)

            def _drop_lead(a):
                spec = tuple(a.sharding.spec)[1:]
                spec = spec + (None,) * (len(a.shape) - 1 - len(spec))
                return _sds(a.shape[1:], a.dtype, _named(mesh, *spec))

            mb_tree = SH.tree_map(_drop_lead, batch_tree)
            probes.append(("microbatch_vjp", accum - 1, micro_fwd_bwd,
                           (aparams, mb_tree)))
        gp = _group_probes(cfg, sctx, mesh, b_ax, micro, s_tok, n_ctx,
                           enc_len, train=True, rules=rules)
        probes += [(lbl, mult * accum, fn, a) for lbl, mult, fn, a in gp]
        cp = _ssm_chunk_probes(cfg, mesh, b_ax, micro,
                               s_tok + cfg.meta_tokens, train=True)
        probes += [(lbl, mult * accum, fn, a) for lbl, mult, fn, a in cp]
        return Cell(arch, shape_name, kind, step, args, {}, (0, 1), probes,
                    cfg, meta)

    if kind == "prefill":
        prefill = make_prefill_step(
            cfg, sctx, max_len=s_tok + cfg.meta_tokens + 1,
            n_ctx=n_ctx or enc_len, device=home)
        tok = _sds((batch, s_tok), torch.int32, _named(mesh, b_ax, None))
        kwargs = {}
        if cfg.cross_attn:
            kwargs["ctx_tokens"] = _sds((batch, n_ctx, d), cdt,
                                        _named(mesh, b_ax, None, None))
        if cfg.enc_dec:
            kwargs["enc_embeds"] = _sds((batch, enc_len, d), cdt,
                                        _named(mesh, b_ax, None, None))
        probes = _group_probes(cfg, sctx, mesh, b_ax, batch, s_tok, n_ctx,
                               enc_len, train=False, rules=rules)
        probes += _ssm_chunk_probes(cfg, mesh, b_ax, batch,
                                    s_tok + cfg.meta_tokens, train=False)
        return Cell(arch, shape_name, kind, prefill, (aparams, tok), kwargs,
                    (), probes, cfg, meta)

    # ---- decode
    serve = make_serve_step(cfg, sctx, device=home)
    plan = cfg.decoder_plan() if cfg.enc_dec else cfg.layer_plan()
    s_cache = -(-(s_tok + cfg.meta_tokens + 2) // 16) * 16  # shardable length
    n_ctx_dec = n_ctx or enc_len
    acache = abstract(T.init_cache(cfg, plan, batch, s_cache, n_ctx_dec,
                                   device="meta"))
    batch_sharded = batch > 1
    if cache_seq_axis is None and shape_name == "long_500k":
        cache_seq_axis = "data"  # batch=1: shard the KV sequence dim instead
    meta["cache_seq_axis"] = cache_seq_axis
    cshard = SH.cache_shardings(mesh, multi_pod, acache, cfg,
                                seq_axis=cache_seq_axis,
                                batch_sharded=batch_sharded)
    acache = _shard_abstract(acache, cshard)
    tok_spec = (b_ax, None) if batch_sharded else (None, None)
    tok = _sds((batch, 1), torch.int32, _named(mesh, *tok_spec))
    pos = _sds((), torch.int32, _named(mesh))
    args = (aparams, acache, tok, pos)
    probes = _decode_probes(cfg, sctx, mesh, b_ax, batch, s_cache, n_ctx_dec,
                            cache_seq_axis, batch_sharded, multi_pod, rules)
    return Cell(arch, shape_name, kind, serve, args, {}, (1,), probes, cfg,
                meta)


# ------------------------------------------------------------ layer probes
def _one_layer_abstract(cfg, mesh, rules, groups_key, gi, repeat):
    """Abstract one-layer (unstacked) params of group gi with shardings."""
    gspec = PM.param_specs(cfg)[groups_key][gi]
    dtype = torch_dtype(cfg.param_dtype)

    def one(p):
        shape = p.shape[1:] if repeat > 1 else p.shape
        axes = p.axes[1:] if repeat > 1 else p.axes
        spec = tuple(rules.get(a) if a else None for a in axes)
        return _sds(shape, dtype, _named(mesh, *spec))

    return PM.tree_map(one, gspec)


def _group_probes(cfg, sctx, mesh, b_ax, micro, s_tok, n_ctx, enc_len, *,
                  train: bool, rules=None):
    """fwd (+vjp when training) per repeated group, multiplier repeat-1.

    Train cost per extra layer = fwd (fwd pass) + vjp (remat-fwd + bwd).
    """
    rules = dict(rules or SH.DEFAULT_RULES)
    cdt = torch_dtype(cfg.compute_dtype)
    probes = []
    for groups_key, plan, is_enc in _plans(cfg):
        s_here = enc_len if is_enc else s_tok + cfg.meta_tokens
        for gi, (unit, repeat) in enumerate(plan):
            if repeat <= 1:
                continue
            x = _sds((micro, s_here, cfg.d_model), cdt,
                     _named(mesh, b_ax, None, None))
            lp = _one_layer_abstract(cfg, mesh, rules, groups_key, gi, repeat)
            pos = _sds((micro, s_here), torch.int32, _named(mesh, b_ax, None))
            ctx = None
            if any(sp.cross for sp in unit):
                ctx = _sds((micro, n_ctx or enc_len, cfg.d_model), cdt,
                           _named(mesh, b_ax, None, None))

            def fwd(x_, lp_, pos_, ctx_=None, unit=unit):
                return T._unit_fwd(cfg, unit, lp_, x_, pos_, sctx,
                                   mode="train", lc=None, pos=None,
                                   ctx_tokens=ctx_)

            def vjp(x_, lp_, pos_, ctx_=None, unit=unit):
                def f(x__, lp__):
                    out = T._unit_fwd(cfg, unit, lp__, x__, pos_, sctx,
                                      mode="train", lc=None, pos=None,
                                      ctx_tokens=ctx_)
                    return torch.sum(out.float())

                return _grad(f, x_, lp_)

            args = (x, lp, pos) + ((ctx,) if ctx is not None else ())
            probes.append((f"{groups_key}{gi}_fwd", repeat - 1, fwd, args))
            if train:
                probes.append((f"{groups_key}{gi}_vjp", repeat - 1, vjp, args))
    return probes


def _decode_probes(cfg, sctx, mesh, b_ax, batch, s_cache, n_ctx,
                   cache_seq_axis, batch_sharded, multi_pod, rules=None):
    cdt = torch_dtype(cfg.compute_dtype)
    probes = []
    rules = dict(rules or SH.DEFAULT_RULES)
    for groups_key, plan, is_enc in _plans(cfg):
        if is_enc:
            continue  # encoder does not run at decode time
        for gi, (unit, repeat) in enumerate(plan):
            if repeat <= 1:
                continue
            x_spec = (b_ax, None, None) if batch_sharded else (None, None, None)
            x = _sds((batch, 1, cfg.d_model), cdt, _named(mesh, *x_spec))
            lp = _one_layer_abstract(cfg, mesh, rules, groups_key, gi, repeat)
            ac = abstract({
                f"sub{i}": T.init_layer_cache(cfg, sp, batch, s_cache, n_ctx,
                                              device="meta")
                for i, sp in enumerate(unit)})
            cs = SH.cache_shardings(mesh, multi_pod, ac, cfg,
                                    seq_axis=cache_seq_axis,
                                    batch_sharded=batch_sharded)
            ac = _shard_abstract(ac, cs)
            pos = _sds((), torch.int32, _named(mesh))

            @torch.no_grad()
            def dec(x_, lp_, cache_, pos_, unit=unit):
                # the cache is written in place and returned, as the
                # reference returns its new cache
                out = T._unit_fwd(cfg, unit, lp_, x_, None, sctx,
                                  mode="decode", lc=cache_, pos=int(pos_),
                                  ctx_tokens=None)
                return out, cache_

            probes.append((f"{groups_key}{gi}_dec", repeat - 1, dec,
                           (x, lp, ac, pos)))
    return probes


def _ssm_chunk_probes(cfg, mesh, b_ax, micro, s_total, *, train: bool):
    """One chunk of the SSM scan: multiplier = sum_g R_g·n_ssm·(n_chunks-1)."""
    if not cfg.ssm:
        return []
    chunk = RW.CHUNK if cfg.ssm.kind == "rwkv6" else MB.CHUNK
    n_chunks = -(-s_total // chunk)
    if n_chunks <= 1:
        return []
    layers = 0
    for _, plan, is_enc in _plans(cfg):
        for unit, repeat in plan:
            layers += repeat * sum(1 for sp in unit if sp.ssm)
    mult = layers * (n_chunks - 1)
    d = cfg.d_model
    di = cfg.ssm.d_inner or d
    f32 = torch.float32
    bsp = _named(mesh, b_ax, None, None, None)
    probes = []
    if cfg.ssm.kind == "rwkv6":
        h = di // cfg.head_dim
        hd = cfg.head_dim
        state = _sds((micro, h, hd, hd), f32,
                     _named(mesh, b_ax, None, None, None))
        seq4 = _sds((micro, chunk, h, hd), f32, bsp)
        u = _sds((h, hd), f32, _named(mesh, None, None))

        def fwd(state_, r, k, v, lw, u_):
            return RW._chunk_step(state_, r, k, v, lw, u_)

        args = (state, seq4, seq4, seq4, seq4, u)
        probes.append(("ssm_chunk_fwd", mult, fwd, args))
        if train:
            def vjp(state_, r, k, v, lw, u_):
                def f(s_, r_, k_, v_, lw_):
                    ns, y = RW._chunk_step(s_, r_, k_, v_, lw_, u_)
                    return torch.sum(ns) + torch.sum(y)

                return _grad(f, state_, r, k, v, lw)

            probes.append(("ssm_chunk_vjp", mult, vjp, args))
    else:
        n = cfg.ssm.state
        hsp = _named(mesh, b_ax, "model", None)
        h0 = _sds((micro, di, n), f32, hsp)
        uu = _sds((micro, chunk, di), f32, _named(mesh, b_ax, None, "model"))
        bb = _sds((micro, chunk, n), f32, _named(mesh, b_ax, None, None))
        ll = _sds((micro, chunk, di), f32, _named(mesh, b_ax, None, "model"))

        def fwd(h_, uu_, bb_, cc_, ll_):
            return MB._chunk_step(h_, uu_, bb_, cc_, ll_)

        args = (h0, uu, bb, bb, ll)
        probes.append(("ssm_chunk_fwd", mult, fwd, args))
        if train:
            def vjp(h_, uu_, bb_, cc_, ll_):
                def f(a, b, c, d_, e):
                    ns, y = MB._chunk_step(a, b, c, d_, e)
                    return torch.sum(ns) + torch.sum(y)

                return _grad(f, h_, uu_, bb_, cc_, ll_)

            probes.append(("ssm_chunk_vjp", mult, vjp, args))
    return probes
