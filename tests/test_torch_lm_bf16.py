"""The port's LM stack in bfloat16 against the JAX reference on the CPU.

The published configs all compute in bfloat16; the smoke configs in
float32. Here every smoke config is run with ``param_dtype`` and
``compute_dtype`` set to bfloat16, on the reference's ``init_params``
output (drawn in float32, cast to bfloat16 by the reference) carried into
the port by ``params_from_jax`` (which widens bfloat16 exactly).

Module by module (the reference run op by op, each op rounding to
bfloat16 as the port's eager ops do):
  - ``embed_tokens`` at every arch's published width, bitwise (the scale
    sqrt(d_model) rounded to bfloat16 first as the reference does, 45.25
    for 2048: scaling by the float32 45.2548 moves ~3% of the values by
    an ulp);
and within rtol 2**-7 (one bfloat16 ulp is 2**-8 to 2**-7 of a value)
and atol 2**-14:
  - attention: causal with QKV bias, sliding window with logit softcap, the
    ring cache's prefill and two decode steps past the window, and
    cross-attention (the logits a bfloat16 product, then float32);
  - the router's top-k on tied logits (the lower index first, as
    ``jax.lax.top_k``);
  - dense FFN for every ``act`` and the MoE (llama4's shared expert at
    top-1, arctic's dense residual at top-2), with atol 2**-5 of the
    output's RMS: the reference's bfloat16 activations on the CPU are not
    correctly rounded (``TOL_ACT_RMS``), the port's are.

The whole model (the reference compiled whole with ``jax.jit``), for every
arch: ``forward`` logits, the prefill step's last logits and every cache
leaf, and one decode step's logits and caches, each within 2**-4 of the
reference tensor's RMS (hymba 2**-3, ``RULE_RMS``) plus 2**-7 of each
value's magnitude (the rule phase 10 of ``chip_smoke.py`` holds the
card's bfloat16 decode to): bfloat16 intermediates that land one ulp
apart (the reference's activations above, a float32 softmax of two
libraries rounded to bfloat16) spread through the layers. ``slot_pos`` exactly. A token whose route in some MoE layer is a
near-tie (the port's top-k logit within 2**-6 of the next, relative) may
go to another expert than in the reference; such positions are held to
the tensor's RMS rule alone (2**-2 of the RMS), every other position to
the full rule.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jx_configs  # noqa: E402
from repro.models import attention as jx_attn  # noqa: E402
from repro.models import ffn as jx_ffn  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.models import transformer as jx_T  # noqa: E402
from repro.models.common import ShardCtx as JxShardCtx  # noqa: E402
from repro.serving import engine as jx_E  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.models import attention as pt_attn  # noqa: E402
from repro_torch.models import ffn as pt_ffn  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.models import transformer as pt_T  # noqa: E402
from repro_torch.serving import engine as pt_E  # noqa: E402

ARCHS = jx_configs.names()
B, S = 2, 16
TOL_OP = dict(rtol=2.0 ** -7, atol=2.0 ** -14)
# XLA:CPU evaluates a bfloat16 activation op by op in bfloat16 (silu as
# neg, exp, add, div and mul, each rounded): ~40% of its silu values are
# an ulp off the correctly rounded ones that torch gives (float32 inside,
# rounded once), and the down projection sums those ulps over d_ff.
TOL_ACT_RMS = 2.0 ** -5
RULE = (2.0 ** -4, 2.0 ** -7)  # of the tensor's RMS, of each |value|
# hymba's six layers feed a float32 Mamba state from bfloat16 activations:
# at its last layer both packages' bfloat16 caches lie ~0.1 of the RMS
# from the same weights run in float32 (the reference's K cache 0.125,
# the port's 0.091), so they are held 2**-3 of the RMS apart.
RULE_RMS = {"hymba-1.5b": 2.0 ** -3}
RULE_NEAR_TIE = 2.0 ** -2  # of the RMS, at a position routed at a near-tie
NEAR_TIE = 2.0 ** -6  # relative top-k margin of a router's logits


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(x):
    """The same bfloat16 values as a jnp array and a torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    p = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    np.testing.assert_array_equal(_np(j), _np(p))
    return j, p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(bfloat16 config pair, reference params, the port's params)."""
    jcfg = _bf16(jx_configs.get_smoke(arch))
    pcfg = _bf16(pt_configs.get_smoke(arch))
    jp = jax.jit(functools.partial(jx_params.init_params, jcfg))(
        jax.random.PRNGKey(1))
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree.leaves(jp))
    pp = pt_params.params_from_jax(pcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jcfg, pcfg, jp, pp


def _layer(arch, group, sub, key, layer=0):
    jcfg, pcfg, jp, pp = _weights(arch)
    j = jp["groups"][group][f"sub{sub}"][key]
    p = pp["groups"][group][f"sub{sub}"][key]
    if jcfg.layer_plan()[group][1] > 1:
        j = jax.tree.map(lambda a: a[layer], j)
        p = pt_params.tree_map(lambda t: t[layer], p)
    return jcfg, pcfg, j, p


def _close(got, want, what="", rms_atol=None):
    """Within TOL_OP; with ``rms_atol``, atol is that share of ``want``'s
    RMS instead."""
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    want = _np(want)
    tol = dict(TOL_OP)
    if rms_atol is not None:
        tol["atol"] = rms_atol * float(np.sqrt(np.mean(np.square(want))))
    np.testing.assert_allclose(_np(got), want, err_msg=what, **tol)


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_tokens_at_the_published_width(arch):
    jcfg, pcfg = jx_configs.get(arch), pt_configs.get(arch)
    assert jcfg.compute_dtype == "bfloat16"
    table = _x((64, jcfg.d_model), 1)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 7))
    want = jx_T.embed_tokens(jcfg, {"embed": _pair(table)[0]},
                             jnp.asarray(tokens))
    got = pt_T.embed_tokens(pcfg, {"embed": _pair(table)[1]},
                            torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=arch)


ATTN_CASES = {
    # arch, group, sub, window, S (as in test_torch_models.py)
    "bias": ("qwen2.5-3b", 0, 0, 0, 11),
    "window_softcap": ("gemma2-2b", 0, 0, 8, 13),
    "global_softcap": ("gemma2-2b", 0, 1, 0, 13),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_self_attention_prefill_cache_and_decode(case):
    arch, group, sub, window, s = ATTN_CASES[case]
    jcfg, pcfg, jp, pp = _layer(arch, group, sub, "attn")
    jx, px = _pair(_x((2, s, jcfg.d_model), 4))
    pos = np.tile(np.arange(s), (2, 1))
    jo, (jk, jv) = jx_attn.self_attention(jcfg, jp, jx, jnp.asarray(pos),
                                          window=window)
    po, (pk, pv) = pt_attn.self_attention(pcfg, pp, px,
                                          torch.from_numpy(pos),
                                          window=window)
    for name, a, b in (("out", po, jo), ("k", pk, jk), ("v", pv, jv)):
        _close(a, b, name)
    jc = jx_attn.init_attn_cache(jcfg, 2, s + 3, window)
    pc = pt_attn.init_attn_cache(pcfg, 2, s + 3, window,
                                 dtype=torch.bfloat16, device="cpu")
    jc = jx_attn.prefill_attn_cache(jc, jk, jv, jnp.asarray(pos))
    pc = pt_attn.prefill_attn_cache(pc, pk, pv, torch.from_numpy(pos))
    for step in range(2):  # two decode steps past the prompt (and window)
        jxt, pxt = _pair(_x((2, 1, jcfg.d_model), 5 + step))
        jo, jc = jx_attn.decode_attention(jcfg, jp, jxt, jc, s + step,
                                          window=window)
        po, pc = pt_attn.decode_attention(pcfg, pp, pxt, pc, s + step,
                                          window=window)
        _close(po, jo, f"decode {step}")
        for key in ("k", "v"):
            _close(pc[key], jc[key], f"cache {key} {step}")


def test_cross_attention_with_gate():
    arch = "llama-3.2-vision-11b"
    jcfg, pcfg, jp, pp = _layer(arch, 0, 0, "xattn", layer=1)
    jp = dict(jp, gate=jnp.asarray(0.7, jnp.bfloat16))  # zero-init: open it
    pp = dict(pp, gate=torch.tensor(0.7, dtype=torch.bfloat16))
    jx, px = _pair(_x((2, 5, jcfg.d_model), 6))
    jctx, pctx = _pair(_x((2, 16, jcfg.d_model), 7))
    jkv = jx_attn.ctx_kv(jcfg, jp, jctx)
    pkv = pt_attn.ctx_kv(pcfg, pp, pctx)
    _close(pt_attn.cross_attention(pcfg, pp, px, pkv),
           jx_attn.cross_attention(jcfg, jp, jx, jkv))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b", "starcoder2-3b"])
def test_dense_ffn_every_act(arch):
    jcfg, pcfg, jp, pp = _layer(arch, 0, 0, "ffn")
    jx, px = _pair(_x((2, 9, jcfg.d_model), 8))
    _close(pt_ffn.dense_ffn(pcfg, pp, px), jx_ffn.dense_ffn(jcfg, jp, jx),
           rms_atol=TOL_ACT_RMS)


@pytest.mark.parametrize("arch,group,sub", [
    ("llama4-maverick-400b-a17b", 0, 1), ("arctic-480b", 0, 0)])
def test_moe_ffn(arch, group, sub):
    jcfg, pcfg, jp, pp = _layer(arch, group, sub, "moe")
    jx, px = _pair(_x((2, 9, jcfg.d_model), 9))
    _close(pt_ffn.moe_ffn(pcfg, pp, px),
           jx_ffn.moe_ffn(jcfg, jp, jx, JxShardCtx()), rms_atol=TOL_ACT_RMS)


def test_router_top_k_takes_tied_experts_in_index_order():
    cfg = _bf16(pt_configs.get_smoke("arctic-480b"))  # top-2 of 8
    logits = np.array([[1, 3, 3, 2, 3, 0, 0, 0], [5] * 8,
                       [0, 0, 0, 0, 0, 0, 2, 2]], np.float32)
    jg, ji = jx_ffn._route(cfg, _pair(logits)[0])
    pg, pi = pt_ffn._route(cfg, _pair(logits)[1])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), [[1, 2], [0, 1], [6, 7]])
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6)


# ------------------------------------------------------------ the model
def _inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ctx = enc = None
    if cfg.cross_attn:
        ctx = rng.normal(size=(B, cfg.cross_attn.n_ctx, cfg.d_model)
                         ).astype(np.float32)
    if cfg.enc_dec:
        enc = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return tokens, ctx, enc


def _n_ctx(ctx, enc):
    return ctx.shape[1] if ctx is not None else (S if enc is not None else 0)


def _j(x):
    return None if x is None else jnp.asarray(x)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's bfloat16 results on one arch, as numpy."""
    cfg, _, params, _ = _weights(arch)
    tokens, ctx, enc = _inputs(cfg)
    full_ctx = jax.jit(functools.partial(jx_T.encode, cfg))(
        params, _j(enc)) if cfg.enc_dec else _j(ctx)
    full, _ = jax.jit(functools.partial(jx_T.forward, cfg))(
        params, jnp.asarray(tokens), ctx_tokens=full_ctx)
    prefill = jax.jit(jx_E.make_prefill_step(
        cfg, max_len=S + cfg.meta_tokens + 4, n_ctx=_n_ctx(ctx, enc)))
    last, caches = prefill(params, jnp.asarray(tokens[:, :S - 1]),
                           ctx_tokens=_j(ctx), enc_embeds=_j(enc))
    pre = _leaves(caches)
    dec, caches = jax.jit(functools.partial(
        jx_T.forward, cfg, mode="decode"))(
        params, jnp.asarray(tokens[:, S - 1:]), caches=caches,
        pos=jnp.asarray(S - 1 + cfg.meta_tokens, jnp.int32))
    return dict(full=_np(full), last=_np(last), pre_caches=pre, dec=_np(dec),
                dec_caches=_leaves(caches))


def _leaves(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _np(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _Routes:
    """Records, while active, the tokens the port's routers placed at a
    near-tie: (token index of the call, call number)."""

    def __init__(self, monkeypatch):
        self.near = []
        route = pt_ffn._route

        def spy(cfg, logits):
            top = torch.topk(logits.float(), cfg.moe.top_k + 1, dim=-1).values
            margin = (top[:, -2] - top[:, -1]) / top[:, -2].abs().clamp(
                min=1e-30)
            self.near.append(set(torch.nonzero(margin <= NEAR_TIE)
                                 .flatten().tolist()))
            return route(cfg, logits)

        monkeypatch.setattr(pt_ffn, "_route", spy)

    def positions(self, b, s):
        """(batch, position) pairs of the flattened (b*s) near-ties: an
        eighth of the positions at most, or the routers are broken."""
        out = {(n // s, n % s) for calls in self.near for n in calls}
        assert len(out) <= max(1, b * s // 8), out
        return out


def _hold(got, want, what, arch, exempt=()):
    """The model-level rule; ``exempt``: (batch, position) pairs along the
    first two axes held to the RMS rule alone."""
    got = _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    excess = np.abs(got - want) - (RULE_RMS.get(arch, RULE[0]) * rms
                                   + RULE[1] * np.abs(want))
    for b, s in exempt:
        excess[b, s] = np.abs(got[b, s] - want[b, s]) - RULE_NEAR_TIE * rms
    assert excess.max() <= 0, (
        f"{what}: |got - want| exceeds the rule by {excess.max():.4g} "
        f"(RMS {rms:.4g}) at {np.unravel_index(excess.argmax(), got.shape)}")


def _hold_caches(got, want, arch, exempt=()):
    got = dict(pt_params.tree_leaves(got))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        g = got[path]
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(_np(g), a, err_msg=path)
        elif path.endswith((".k", ".v")) and exempt:
            # ring slots (repeat, B, slot, ...): near-ties by slot_pos
            sp = _np(got[path[:-1] + "slot_pos"])[0].astype(int)
            slot = {int(p): i for i, p in enumerate(sp) if p >= 0}
            ex = [(b, slot[s]) for b, s in exempt if s in slot]
            _hold(g.movedim(0, 2) if g.dim() == 5 else g,
                  np.moveaxis(a, 0, 2) if a.ndim == 5 else a, path, arch, ex)
        else:
            _hold(g, a, path, arch)


def _port(arch, monkeypatch):
    _, cfg, _, params = _weights(arch)
    tokens, ctx, enc = _inputs(cfg)
    return cfg, params, tokens, ctx, enc, _Routes(monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, monkeypatch):
    cfg, params, tokens, ctx, enc, routes = _port(arch, monkeypatch)
    ctx_t = pt_T.encode(cfg, params, torch.from_numpy(enc)) if cfg.enc_dec \
        else (None if ctx is None else torch.from_numpy(ctx))
    logits, _ = pt_T.forward(cfg, params, torch.from_numpy(tokens).long(),
                             ctx_tokens=ctx_t)
    assert logits.dtype == torch.float32
    _hold(logits, _reference(arch)["full"], "logits", arch,
          routes.positions(B, S))


def _prefill(cfg, params, tokens, ctx, enc):
    step = pt_E.make_prefill_step(cfg, max_len=S + cfg.meta_tokens + 4,
                                  n_ctx=_n_ctx(ctx, enc), device="cpu")
    return step(params, tokens[:, :S - 1], ctx_tokens=ctx, enc_embeds=enc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_reference(arch, monkeypatch):
    cfg, params, tokens, ctx, enc, routes = _port(arch, monkeypatch)
    last, caches = _prefill(cfg, params, tokens, ctx, enc)
    near = routes.positions(B, S - 1 + cfg.meta_tokens)
    ref = _reference(arch)
    _hold(last[:, None], ref["last"][:, None], "last logits", arch,
          {(b, 0) for b, s in near if s == S - 2 + cfg.meta_tokens})
    _hold_caches(caches, ref["pre_caches"], arch, near)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, monkeypatch):
    cfg, params, tokens, ctx, enc, routes = _port(arch, monkeypatch)
    _, caches = _prefill(cfg, params, tokens, ctx, enc)
    near = routes.positions(B, S - 1 + cfg.meta_tokens)
    routes.near.clear()
    pos = S - 1 + cfg.meta_tokens
    with torch.inference_mode():
        logits, caches = pt_T.forward(
            cfg, params, torch.from_numpy(tokens[:, S - 1:]).long(),
            mode="decode", caches=caches, pos=pos)
    near |= {(b, pos) for b, _ in routes.positions(B, 1)}
    ref = _reference(arch)
    _hold(logits, ref["dec"], "decode logits", arch,
          {(b, 0) for b, s in near if s == pos})
    _hold_caches(caches, ref["dec_caches"], arch, near)
