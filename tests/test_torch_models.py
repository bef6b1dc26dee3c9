"""The port's LM building blocks (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference's (``repro.models``, ``repro.configs``) on the CPU.

Every module is held on the same numpy inputs (made from a seed) and the
same weights: the reference's ``init_params`` output, carried into the
port by ``params_from_jax``. All ten smoke configs compute in float32.
Tolerances:
  - configs, layer plans, parameter specs, ``count_params``, ``n_params``
    and ``n_active_params``: exactly equal, for the full and smoke configs;
  - ``rms_norm``, ``rope`` (float32 and bfloat16 in, computed in float32)
    and ``activate`` for every ``act``: rtol 1e-6 / atol 1e-6 (float32
    transcendental functions of two libraries, a few ulps apart); bfloat16
    outputs within one bfloat16 ulp (rtol 2**-7);
  - attention (causal with QKV bias, sliding window with logit softcap,
    cross-attention with its gate, the ring cache's prefill and a decode
    step past the window), dense FFN for every ``act`` and the MoE
    (llama4's shared expert at top-1, arctic's dense residual at top-2,
    and arctic at a capacity that drops tokens): rtol 1e-5 / atol 1e-5 on
    outputs of magnitude ~1 (float32 products summed in another order);
    caches' ``slot_pos`` exactly;
  - ``rwkv6_mix`` and ``mamba_mix`` (chunked) and their decode steps:
    rtol 1e-5 / atol 1e-5 against the reference; against the port's own
    sequential ``_ref`` oracles at the reference test's rtol 2e-4 / atol
    2e-5 (chunked and sequential sum in different orders).
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
from repro.models import common as jx_common  # noqa: E402
from repro.models import ffn as jx_ffn  # noqa: E402
from repro.models import mamba as jx_mamba  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.models import rwkv as jx_rwkv  # noqa: E402
from repro.models.common import ShardCtx as JxShardCtx  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.models import attention as pt_attn  # noqa: E402
from repro_torch.models import common as pt_common  # noqa: E402
from repro_torch.models import ffn as pt_ffn  # noqa: E402
from repro_torch.models import mamba as pt_mamba  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.models import rwkv as pt_rwkv  # noqa: E402

ARCHS = jx_configs.names()
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_FN = dict(rtol=1e-6, atol=1e-6)
TOL_SEQ = dict(rtol=2e-4, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pt(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=0):
    """(reference params as jnp, the port's params) for a smoke config."""
    cfg = jx_configs.get_smoke(arch)
    jp = jax.jit(functools.partial(jx_params.init_params, cfg))(
        jax.random.PRNGKey(seed))
    pp = pt_params.params_from_jax(pt_configs.get_smoke(arch),
                                   jax.tree.map(np.asarray, jp), device="cpu")
    return jp, pp


def _layer(arch, group, sub, key, layer=0):
    """One layer's ``key`` sub-tree from both packages (stacked groups:
    layer ``layer``)."""
    jp, pp = _weights(arch)
    cfg = jx_configs.get_smoke(arch)
    repeat = cfg.layer_plan()[group][1]
    j = jp["groups"][group][f"sub{sub}"][key]
    p = pp["groups"][group][f"sub{sub}"][key]
    if repeat > 1:
        j = jax.tree.map(lambda a: a[layer], j)
        p = pt_params.tree_map(lambda t: t[layer], p)
    return j, p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_for_field(arch):
    assert pt_configs.names() == jx_configs.names()
    for get in ("get", "get_smoke"):
        a = getattr(pt_configs, get)(arch)
        b = getattr(jx_configs, get)(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.heads_padded, a.kv_padded, a.kv_sharded, a.d_ff_e) == \
            (b.heads_padded, b.kv_padded, b.kv_sharded, b.d_ff_e)
        assert repr(a.layer_plan()) == repr(b.layer_plan())
        if a.enc_dec:
            assert repr(a.encoder_plan()) == repr(b.encoder_plan())
            assert repr(a.decoder_plan()) == repr(b.decoder_plan())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_counts_equal(arch):
    for get in ("get", "get_smoke"):
        a = getattr(pt_configs, get)(arch)
        b = getattr(jx_configs, get)(arch)
        assert pt_params.count_params(a) == jx_params.count_params(b)
        assert a.n_params == b.n_params
        assert a.n_active_params == b.n_active_params
        assert pt_params.vocab_padded(a) == jx_params.vocab_padded(b)
        got = pt_params.tree_leaves(pt_params.param_specs(a))
        want = jax.tree_util.tree_flatten_with_path(
            jx_params.param_specs(b), is_leaf=lambda x: isinstance(
                x, jx_params.P))[0]
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): p for path, p in want}
        assert sorted(p for p, _ in got) == sorted(want)
        for path, p in got:
            w = want[path]
            assert (p.shape, p.axes, p.init, p.scale) == \
                (w.shape, w.axes, w.init, w.scale), path


def test_params_from_jax_carries_every_weight_and_checks_shapes():
    jp, pp = _weights("hymba-1.5b")
    got = dict(pt_params.tree_leaves(pp))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(got) == len(want)
    for path, a in want:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        np.testing.assert_array_equal(_np(got[key]), np.asarray(a))
    bad = jax.tree.map(np.asarray, jp)
    bad["ln_f"] = bad["ln_f"][:-1]
    cfg = pt_configs.get_smoke("hymba-1.5b")
    with pytest.raises(ValueError, match="ln_f"):
        pt_params.params_from_jax(cfg, bad, device="cpu")
    bad = jax.tree.map(np.asarray, jp)
    bad["extra"] = np.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        pt_params.params_from_jax(cfg, bad, device="cpu")


def test_params_from_jax_widens_bfloat16_exactly():
    jp, _ = _weights("qwen2.5-3b")
    jp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    pcfg = dataclasses.replace(pt_configs.get_smoke("qwen2.5-3b"),
                               param_dtype="bfloat16")
    pp = pt_params.params_from_jax(pcfg, jp, device="cpu")
    assert pp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["embed"].float().numpy(),
                                  jp["embed"].astype(np.float32))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b", "hymba-1.5b",
                                  "arctic-480b"])
def test_init_params_shapes_scales_and_kinds(arch):
    cfg = pt_configs.get_smoke(arch)
    g = torch.Generator().manual_seed(0)
    params = pt_params.init_params(cfg, generator=g, device="cpu")
    specs = dict(pt_params.tree_leaves(pt_params.param_specs(cfg)))
    jref = _weights(arch)[0]
    jleaves = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path): a
               for path, a in jax.tree_util.tree_flatten_with_path(jref)[0]}
    for path, t in pt_params.tree_leaves(params):
        p = specs[path]
        assert tuple(t.shape) == p.shape and t.dtype == torch.float32
        if p.init in ("zeros", "ones", "decay"):  # deterministic kinds
            np.testing.assert_array_equal(_np(t), np.asarray(jleaves[path]))
        elif t.numel() >= 1000:  # normal: the spec's scale
            assert abs(float(t.std()) / p.scale - 1) < 0.1, path
    again = pt_params.init_params(cfg, generator=torch.Generator()
                                  .manual_seed(0), device="cpu")
    for (_, a), (_, b) in zip(pt_params.tree_leaves(params),
                              pt_params.tree_leaves(again)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    x = _x((2, 7, 3, 16), 0)
    w = _x((16,), 1)
    pos = np.tile(np.arange(3, 10), (2, 1))
    jx = jnp.asarray(x).astype(dtype)
    px = _pt(x).to(getattr(torch, dtype))
    tol = TOL_FN if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(
        _np(pt_common.rms_norm(px, _pt(w), 1e-5).float()),
        np.asarray(jx_common.rms_norm(jx, jnp.asarray(w), 1e-5), np.float32),
        **tol)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(pt_common.rope(px, _pt(pos), theta).float()),
            np.asarray(jx_common.rope(jx, jnp.asarray(pos), theta),
                       np.float32), **tol)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_activate_every_act(act):
    g, u = _x((4, 33), 2) * 3, _x((4, 33), 3)
    np.testing.assert_allclose(
        _np(pt_common.activate(act, _pt(g), _pt(u))),
        np.asarray(jx_common.activate(act, jnp.asarray(g), jnp.asarray(u))),
        **TOL_FN)
    np.testing.assert_allclose(
        _np(pt_common.softcap(_pt(g * 30), 50.0)),
        np.asarray(jx_common.softcap(jnp.asarray(g * 30), 50.0)), **TOL_FN)


# --------------------------------------------------------------- attention
ATTN_CASES = {
    # arch, group, sub, window, S: causal with QKV bias; local with softcap
    # past its window of 8; a plain global layer of the VLM
    "bias": ("qwen2.5-3b", 0, 0, 0, 11),
    "window_softcap": ("gemma2-2b", 0, 0, 8, 13),
    "global_softcap": ("gemma2-2b", 0, 1, 0, 13),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_self_attention_prefill_cache_and_decode(case):
    arch, group, sub, window, s = ATTN_CASES[case]
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _layer(arch, group, sub, "attn")
    x = _x((2, s, jcfg.d_model), 4)
    pos = np.tile(np.arange(s), (2, 1))
    jo, (jk, jv) = jx_attn.self_attention(jcfg, jp, jnp.asarray(x),
                                          jnp.asarray(pos), window=window)
    po, (pk, pv) = pt_attn.self_attention(pcfg, pp, _pt(x), _pt(pos),
                                          window=window)
    for a, b in ((po, jo), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)

    max_len = s + 3
    jc = jx_attn.init_attn_cache(jcfg, 2, max_len, window)
    pc = pt_attn.init_attn_cache(pcfg, 2, max_len, window,
                                 dtype=torch.float32, device="cpu")
    jc = jx_attn.prefill_attn_cache(jc, jk, jv, jnp.asarray(pos))
    pc = pt_attn.prefill_attn_cache(pc, pk, pv, _pt(pos))
    _same_cache(pc, jc)
    for step in range(2):  # two decode steps past the prompt (and window)
        xt = _x((2, 1, jcfg.d_model), 5 + step)
        jo, jc = jx_attn.decode_attention(jcfg, jp, jnp.asarray(xt), jc,
                                          s + step, window=window)
        po, pc = pt_attn.decode_attention(pcfg, pp, _pt(xt), pc, s + step,
                                          window=window)
        np.testing.assert_allclose(_np(po), np.asarray(jo), **TOL)
        _same_cache(pc, jc)


def _same_cache(pc, jc):
    np.testing.assert_array_equal(_np(pc["slot_pos"]),
                                  np.asarray(jc["slot_pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(pc[key]), np.asarray(jc[key]), **TOL)


def test_cross_attention_with_gate_and_ctx_kv():
    arch = "llama-3.2-vision-11b"
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _layer(arch, 0, 0, "xattn", layer=1)
    jp = dict(jp, gate=jnp.asarray(0.7, jnp.float32))  # zero-init: open it
    pp = dict(pp, gate=torch.tensor(0.7))
    x, ctx = _x((2, 5, jcfg.d_model), 6), _x((2, 16, jcfg.d_model), 7)
    jkv = jx_attn.ctx_kv(jcfg, jp, jnp.asarray(ctx))
    pkv = pt_attn.ctx_kv(pcfg, pp, _pt(ctx))
    for a, b in zip(pkv, jkv):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        _np(pt_attn.cross_attention(pcfg, pp, _pt(x), pkv)),
        np.asarray(jx_attn.cross_attention(jcfg, jp, jnp.asarray(x), jkv)),
        **TOL)


# --------------------------------------------------------------------- ffn
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b", "starcoder2-3b"])
def test_dense_ffn_every_act(arch):
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _layer(arch, 0, 0, "ffn")
    x = _x((2, 9, jcfg.d_model), 8)
    np.testing.assert_allclose(
        _np(pt_ffn.dense_ffn(pcfg, pp, _pt(x))),
        np.asarray(jx_ffn.dense_ffn(jcfg, jp, jnp.asarray(x))), **TOL)


MOE_CASES = {
    "llama4_shared_top1": ("llama4-maverick-400b-a17b", 0, 1, None),
    "arctic_dense_top2": ("arctic-480b", 0, 0, None),
    "arctic_drops": ("arctic-480b", 0, 0, 1.0),  # capacity 4 of 9 a expert
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn(case):
    arch, group, sub, cap = MOE_CASES[case]
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    if cap is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=cap))
    jp, pp = _layer(arch, group, sub, "moe")
    x = _x((2, 9, jcfg.d_model), 9)
    want = np.asarray(jx_ffn.moe_ffn(jcfg, jp, jnp.asarray(x), JxShardCtx()))
    np.testing.assert_allclose(_np(pt_ffn.moe_ffn(pcfg, pp, _pt(x))), want,
                               **TOL)
    if cap is not None:  # tokens dropped: some rows carry the dense path only
        dense = np.asarray(jx_ffn.dense_ffn(jcfg, jp["dense"], jnp.asarray(x)))
        assert np.any(np.all(np.isclose(want, dense, rtol=1e-6, atol=1e-6),
                             axis=-1))


# -------------------------------------------------------------------- ssm
@pytest.mark.parametrize("s", [1, 16, 37])
def test_rwkv6_mix_and_decode(s):
    arch = "rwkv6-3b"
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _layer(arch, 0, 0, "ssm", layer=1)
    x = _x((2, s, jcfg.d_model), 10)
    jo, (jxl, jst) = jx_rwkv.rwkv6_mix(jcfg, jp, jnp.asarray(x))
    po, (pxl, pst) = pt_rwkv.rwkv6_mix(pcfg, pp, _pt(x))
    for a, b in ((po, jo), (pxl, jxl), (pst, jst)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(_np(po), _np(pt_rwkv.rwkv6_mix_ref(
        pcfg, pp, _pt(x))), **TOL_SEQ)
    xt = _x((2, 1, jcfg.d_model), 11)
    jo, (_, jst) = jx_rwkv.rwkv6_decode(jcfg, jp, jnp.asarray(xt), jxl, jst)
    po, (_, pst) = pt_rwkv.rwkv6_decode(pcfg, pp, _pt(xt), pxl, pst)
    np.testing.assert_allclose(_np(po), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_np(pst), np.asarray(jst), **TOL)


@pytest.mark.parametrize("s", [1, 16, 23])
def test_mamba_mix_and_decode(s):
    arch = "hymba-1.5b"
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _layer(arch, 1, 0, "ssm", layer=1)
    x = _x((2, s, jcfg.d_model), 12)
    jo, (jcs, jh) = jx_mamba.mamba_mix(jcfg, jp, jnp.asarray(x))
    po, (pcs, ph) = pt_mamba.mamba_mix(pcfg, pp, _pt(x))
    for a, b in ((po, jo), (pcs, jcs), (ph, jh)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(_np(po), _np(pt_mamba.mamba_mix_ref(
        pcfg, pp, _pt(x))), **TOL_SEQ)
    xt = _x((2, 1, jcfg.d_model), 13)
    jo, (jcs, jh) = jx_mamba.mamba_decode(jcfg, jp, jnp.asarray(xt), jcs, jh)
    po, (pcs, ph) = pt_mamba.mamba_decode(pcfg, pp, _pt(xt), pcs, ph)
    for a, b in ((po, jo), (pcs, jcs), (ph, jh)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
