"""The port's LM serving path (``repro_torch.models.transformer``,
``repro_torch.serving.engine``) against the JAX reference's on the CPU, for
all ten smoke configs.

Each arch runs the reference once (weights from its ``init_params``, a
(2, 16) token batch made from a seed with numpy, the VLM's 16 context
embeddings, the enc-dec's 16 frame embeddings) and the port on the same
inputs, with the weights carried by ``params_from_jax``. Held:
  - ``forward`` logits (teacher-forced, 16 tokens): rtol 1e-5 / atol 1e-4
    (float32 logits of magnitude up to ~75, products summed in another
    order);
  - the prefill step on the first 15 tokens: its last logits at the same
    tolerance; every cache leaf (ring K/V, recurrent state, conv state,
    cross-attention K/V) at rtol 1e-4 / atol 1e-4 (float32 values of
    magnitude up to ~5 after up to six layers, the SSM states after a
    chunked scan the reference sums in another order), ``slot_pos``
    exactly;
  - one decode step at position 15 (+ meta tokens): logits and caches as
    above;
  - ``generate``'s 4 greedy tokens: exactly.
The reference's steps run compiled whole (``jax.jit`` of its
``forward``, ``make_prefill_step``'s step and ``generate``).
On the port alone: decode equals prefill (the reference's
``test_decode_matches_prefill``, its rtol 2e-3 / atol 2e-3, for every arch),
the chunked RWKV6 and Mamba mixers against their sequential oracles (rtol
2e-4 / atol 2e-5), a decode step writes each layer's own cache slot and
nothing else, the ``Decoder`` module's ``state_dict`` keys are the
reference tree's paths, and the entry points refuse to run without a card
unless given ``device="cpu"``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jx_configs  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.models import transformer as jx_T  # noqa: E402
from repro.serving import engine as jx_E  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.models import transformer as pt_T  # noqa: E402
from repro_torch.serving import engine as pt_E  # noqa: E402

ARCHS = jx_configs.names()
B, S = 2, 16
STEPS = 4
TOL_LOGITS = dict(rtol=1e-5, atol=1e-4)
TOL_CACHE = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
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
    """The reference's results on one arch, as numpy."""
    cfg = jx_configs.get_smoke(arch)
    params = jax.jit(functools.partial(jx_params.init_params, cfg))(
        jax.random.PRNGKey(1))
    tokens, ctx, enc = _inputs(cfg)
    # Each reference step compiled whole (jax.jit): its op-by-op dispatch
    # compiles every op's shape and takes several times longer here.
    full_ctx = jax.jit(functools.partial(jx_T.encode, cfg))(
        params, _j(enc)) if cfg.enc_dec else _j(ctx)
    full, _ = jax.jit(functools.partial(jx_T.forward, cfg))(
        params, jnp.asarray(tokens), ctx_tokens=full_ctx)
    max_len = S + cfg.meta_tokens + 4
    prefill = jax.jit(jx_E.make_prefill_step(cfg, max_len=max_len,
                                             n_ctx=_n_ctx(ctx, enc)))
    last, caches = prefill(params, jnp.asarray(tokens[:, :S - 1]),
                           ctx_tokens=_j(ctx), enc_embeds=_j(enc))
    pre_caches = jax.tree.map(np.asarray, caches)
    dec, caches = jax.jit(functools.partial(
        jx_T.forward, cfg, mode="decode"))(
        params, jnp.asarray(tokens[:, S - 1:]), caches=caches,
        pos=jnp.asarray(S - 1 + cfg.meta_tokens, jnp.int32))
    gen = jax.jit(functools.partial(jx_E.generate, cfg, steps=STEPS))(
        params, jnp.asarray(tokens[:, :S - 1]), ctx_tokens=_j(ctx),
        enc_embeds=_j(enc))
    return dict(params=jax.tree.map(np.asarray, params), full=np.asarray(full),
                last=np.asarray(last), pre_caches=pre_caches,
                dec=np.asarray(dec), dec_caches=jax.tree.map(np.asarray, caches),
                gen=np.asarray(gen))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = pt_configs.get_smoke(arch)
    return pt_params.params_from_jax(cfg, _reference(arch)["params"],
                                     device="cpu")


def _port_prefill(arch):
    cfg = pt_configs.get_smoke(arch)
    tokens, ctx, enc = _inputs(cfg)
    prefill = pt_E.make_prefill_step(cfg, max_len=S + cfg.meta_tokens + 4,
                                     n_ctx=_n_ctx(ctx, enc), device="cpu")
    last, caches = prefill(_port_params(arch), tokens[:, :S - 1],
                           ctx_tokens=ctx, enc_embeds=enc)
    return cfg, tokens, last, caches


def _same_caches(got, want):
    got = dict(pt_params.tree_leaves(got))
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        g = _np(got[path])
        assert g.shape == a.shape, path
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(g, a, err_msg=path)
        else:
            np.testing.assert_allclose(g, a, err_msg=path, **TOL_CACHE)


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    cfg = pt_configs.get_smoke(arch)
    params = _port_params(arch)
    tokens, ctx, enc = _inputs(cfg)
    ctx_t = pt_T.encode(cfg, params, torch.from_numpy(enc)) if cfg.enc_dec \
        else (None if ctx is None else torch.from_numpy(ctx))
    logits, _ = pt_T.forward(cfg, params, torch.from_numpy(tokens).long(),
                             ctx_tokens=ctx_t)
    assert logits.shape == (B, S, pt_params.vocab_padded(cfg))
    np.testing.assert_allclose(_np(logits), _reference(arch)["full"],
                               **TOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_reference(arch):
    _, _, last, caches = _port_prefill(arch)
    ref = _reference(arch)
    np.testing.assert_allclose(_np(last), ref["last"], **TOL_LOGITS)
    _same_caches(caches, ref["pre_caches"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    cfg, tokens, _, caches = _port_prefill(arch)
    with torch.inference_mode():
        logits, caches = pt_T.forward(
            cfg, _port_params(arch), torch.from_numpy(tokens[:, S - 1:]).long(),
            mode="decode", caches=caches, pos=S - 1 + cfg.meta_tokens)
    ref = _reference(arch)
    np.testing.assert_allclose(_np(logits), ref["dec"], **TOL_LOGITS)
    _same_caches(caches, ref["dec_caches"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    cfg = pt_configs.get_smoke(arch)
    tokens, ctx, enc = _inputs(cfg)
    got = pt_E.generate(cfg, _port_params(arch), tokens[:, :S - 1], STEPS,
                        ctx_tokens=ctx, enc_embeds=enc, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(_np(got), _reference(arch)["gen"])


# ------------------------------------------------------------ the port alone
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Greedy decode equals teacher-forced forward argmax (cache
    correctness), on weights from the port's own ``init_params``."""
    cfg = pt_configs.get_smoke(arch)
    params = pt_params.init_params(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    tokens, ctx, enc = _inputs(cfg, seed=1)
    max_len = S + cfg.meta_tokens + 4
    prefill = pt_E.make_prefill_step(cfg, max_len=max_len,
                                     n_ctx=_n_ctx(ctx, enc), device="cpu")
    serve = pt_E.make_serve_step(cfg, device="cpu")
    tok = torch.from_numpy(tokens).long()
    ctx_full = pt_T.encode(cfg, params, torch.from_numpy(enc)) \
        if cfg.enc_dec else (None if ctx is None else torch.from_numpy(ctx))
    full_logits, _ = pt_T.forward(cfg, params, tok, ctx_tokens=ctx_full)
    last, caches = prefill(params, tok[:, :S - 1], ctx_tokens=ctx,
                           enc_embeds=enc)
    np.testing.assert_allclose(_np(last), _np(full_logits[:, S - 2]),
                               rtol=2e-3, atol=2e-3)
    nxt, caches = serve(params, caches, tok[:, S - 1:S],
                        S - 1 + cfg.meta_tokens)
    np.testing.assert_array_equal(_np(nxt)[:, 0],
                                  _np(full_logits[:, S - 1]).argmax(-1))


def _port_layer_ssm(arch, group, seed):
    cfg = pt_configs.get_smoke(arch)
    params = pt_params.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, pt_params.tree_map(lambda t: t[0],
                                   params["groups"][group]["sub0"]["ssm"])


def test_rwkv_chunked_matches_sequential():
    from repro_torch.models import rwkv as R

    cfg, lp = _port_layer_ssm("rwkv6-3b", 0, 2)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 37, cfg.d_model)).astype(np.float32))
    got, _ = R.rwkv6_mix(cfg, lp, x)
    np.testing.assert_allclose(_np(got), _np(R.rwkv6_mix_ref(cfg, lp, x)),
                               rtol=2e-4, atol=2e-5)


def test_mamba_chunked_matches_sequential():
    from repro_torch.models import mamba as M

    cfg, lp = _port_layer_ssm("hymba-1.5b", 1, 4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 23, cfg.d_model)).astype(np.float32))
    got, _ = M.mamba_mix(cfg, lp, x)
    np.testing.assert_allclose(_np(got), _np(M.mamba_mix_ref(cfg, lp, x)),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b", "gemma2-2b"])
def test_decode_writes_each_layers_own_slot_only(arch):
    """``init_cache`` gives every layer of a stacked group storage of its
    own (a broadcast view would alias them, and one in-place write would
    land in every layer): a decode step changes, in each layer, the ring
    slot of its position (or the recurrent state) and nothing else, and
    layers end with different contents."""
    cfg, tokens, _, caches = _port_prefill(arch)
    before = pt_params.tree_map(lambda t: t.clone(), caches)
    pos = S - 1 + cfg.meta_tokens
    serve = pt_E.make_serve_step(cfg, device="cpu")
    serve(_port_params(arch), caches, tokens[:, S - 1:], pos)
    plan = cfg.layer_plan()
    for gi, (unit, repeat) in enumerate(plan):
        new, old = caches[gi]["sub0"], before[gi]["sub0"]
        assert repeat > 1
        for leaf_new, leaf_old in zip(pt_params.tree_leaves(new),
                                      pt_params.tree_leaves(old)):
            path, a = leaf_new
            b = leaf_old[1]
            ptrs = {a[i].data_ptr() for i in range(repeat)}
            assert len(ptrs) == repeat, path  # no two layers share storage
            for i in range(repeat):
                changed = (a[i] != b[i])
                assert bool(changed.any()), (path, i)
                if path.startswith("attn.") and path != "attn.slot_pos":
                    slots = a.shape[2]
                    rows = changed.flatten(2).any(-1).any(0)  # per slot
                    assert rows.nonzero().flatten().tolist() == \
                        [pos % slots], (path, i)
                if i and path != "attn.slot_pos":  # each layer's own values
                    assert not torch.equal(a[i], a[0]), (path, i)


def test_decoder_module_owns_the_reference_paths():
    arch = "llama4-maverick-400b-a17b"
    cfg = pt_configs.get_smoke(arch)
    params = _port_params(arch)
    model = pt_T.Decoder(cfg, params)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                _reference(arch)["params"])[0]}
    assert set(model.state_dict()) == want
    assert model.state_dict()["groups.0.sub1.moe.we_g"].data_ptr() == \
        params["groups"][0]["sub1"]["moe"]["we_g"].data_ptr()
    tokens, _, _ = _inputs(cfg)
    got, _ = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(_np(got), _reference(arch)["full"],
                               **TOL_LOGITS)
    assert model.to(torch.float64).tree()["embed"].dtype == torch.float64


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    cfg = pt_configs.get_smoke("qwen2.5-3b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_params.init_params(cfg, generator=g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_params.params_from_jax(cfg, _reference("qwen2.5-3b")["params"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_E.make_prefill_step(cfg, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_E.make_serve_step(cfg)
    tokens, _, _ = _inputs(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_E.generate(cfg, _port_params("qwen2.5-3b"), tokens, 2)
    # parameters elsewhere than the step's device are refused, not moved
    prefill = pt_E.make_prefill_step(cfg, max_len=S + 4, device="meta")
    with pytest.raises(ValueError, match="lie on cpu"):
        prefill(_port_params("qwen2.5-3b"), tokens)
