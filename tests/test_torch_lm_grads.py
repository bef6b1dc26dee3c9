"""The port's training loss (``repro_torch.training.losses.lm_loss``) and
its gradients against the JAX reference's on the CPU.

Every smoke config, on one set of weights drawn by the port's
``init_params`` (the reference's shapes, scales and init kinds): as numpy
arrays they go into the reference as ``jnp`` arrays and into the port
through ``params_from_jax`` (a JAX ``init_params`` would cost a compile
per config as long as the value-and-grad's). The reference's side is
``jax.jit(jax.value_and_grad(lm_loss))``, compiled once per config (a
module fixture), the port's ``torch.autograd.grad`` with respect to the
parameter tree's leaves. Labels are a random continuation, not the tokens
themselves: with tied random embeddings each token's own logit dominates
and a loss on ``labels == tokens`` is about 0, which would test nothing.

Tolerances, float32:
  - the loss within rtol 1e-6 (a mean of ~32 float32 log-sum-exps of
    logits up to ~300: the two packages part by at most 4e-6 at ~64);
  - each gradient leaf within ``TOL_GRAD`` (1e-4) of its largest
    reference value plus 1e-4 of each value: summation order leaves
    ~1e-6 of the leaf's largest value on every leaf but hymba's fusion
    scalars, each a sum over every position and channel of one layer
    that cancels to 6.3e-5 of its value (CPU study, before this file);
  - recomputation (``remat``) on against off: bitwise, loss and every
    gradient (the recomputed forward runs the same ops on the same data).
bfloat16 (qwen2.5-3b's smoke config cast, as ``test_torch_lm_bf16.py``
casts it): the loss within rtol 2**-8 (its logits, up to ~300, are bf16
products, whose ulp there is 1-2: the packages part by up to 3.2e-4 of
the loss); each gradient leaf's largest difference within ``TOL_BF16_RMS``
(2**-2) of the leaf's RMS: the FFN's gradients part by up to 0.114 of
their RMS over three seeds (CPU study, before this file), since XLA:CPU's
bf16 activations are not correctly rounded (``test_torch_lm_bf16.py``
holds the bf16 FFN's output at 2**-5 of its RMS for that reason), and a
gradient's largest value lies several RMS out.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jx_configs  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.training import losses as jx_losses  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.training import losses as pt_losses  # noqa: E402
from repro_torch.training import train_loop as pt_loop  # noqa: E402

ARCHS = jx_configs.names()
B, S = 2, 16
TOL_LOSS = 1e-6
TOL_GRAD = 1e-4
TOL_BF16_RMS = 2.0 ** -2
TOL_BF16_LOSS = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are small: one intra-op thread is faster than the
    default pool when the test workers share the machine, and leaves the
    cores to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _paths(tree):
    """{path: leaf} of a reference tree ('.'-joined key paths)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _batch(cfg, seed, masked=False):
    """Numpy inputs: tokens, labels from a random continuation (some at -1
    when ``masked``), and ctx / enc embeddings where the config takes
    them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if masked:
        b["labels"][0, :5] = -1
        b["labels"][1, -3:] = -1
    if cfg.cross_attn:
        b["ctx"] = rng.normal(size=(B, cfg.cross_attn.n_ctx, cfg.d_model)
                              ).astype(np.float32)
    if cfg.enc_dec:
        b["enc"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return b


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _configs(arch, cast=None):
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    if cast:
        jcfg, pcfg = cast(jcfg), cast(pcfg)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _weights(arch, cast=None):
    """(the reference's tree of jnp arrays, the port's params): the same
    values, in ``param_dtype`` on both sides."""
    jcfg, pcfg = _configs(arch, cast)
    drawn = pt_params.init_params(
        pcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    host = pt_params.tree_map(lambda t: t.float().numpy(), drawn)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype), host)
    pp = pt_params.params_from_jax(pcfg, host, device="cpu")
    return jp, pp


@pytest.fixture(scope="module")
def reference():
    """``reference(arch, cast)`` -> (loss, grads) of the reference's jitted
    value-and-grad, compiled once per config."""
    compiled = {}

    def run(arch, batch, cast=None):
        if (arch, cast) not in compiled:
            jcfg, _ = _configs(arch, cast)
            compiled[arch, cast] = jax.jit(jax.value_and_grad(
                functools.partial(jx_losses.lm_loss, jcfg)))
        jp, _ = _weights(arch, cast)
        return compiled[arch, cast](jp, _jx(batch))

    return run


def port_loss_and_grads(cfg, params, batch, remat=True):
    """The port's loss and its gradient tree (``value_and_grad``)."""
    return pt_loop.value_and_grad(
        cfg, params, _pt(batch),
        loss_fn=functools.partial(pt_losses.lm_loss, remat=remat))


def _hold_grads(got, want, what):
    want = _paths(want)
    got = dict(pt_params.tree_leaves(got))
    assert set(got) == set(want), what
    for path, w in want.items():
        w = _np(w)
        g = _np(got[path])
        assert g.shape == w.shape, (what, path)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=TOL_GRAD,
                                   atol=TOL_GRAD * scale,
                                   err_msg=f"{what}: {path}")


def _hold(arch, batch, reference):
    _, pcfg = _configs(arch)
    jl, jg = reference(arch, batch)
    pl, pg = port_loss_and_grads(pcfg, _weights(arch)[1], batch)
    assert np.isfinite(float(pl)) and float(pl) > 1.0, float(pl)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL_LOSS)
    _hold_grads(pg, jg, arch)
    return pl, pg


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, reference):
    _hold(arch, _batch(_configs(arch)[0], 1), reference)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_labels_match_reference(arch, reference):
    """Labels at -1 drop out of the loss and its gradient; with every
    label masked the loss is 0 (the sum over max(0, 1) positions)."""
    cfg = _configs(arch)[0]
    batch = _batch(cfg, 2, masked=True)
    _hold(arch, batch, reference)
    keep = batch["labels"] >= 0
    assert 0 < keep.sum() < keep.size
    batch["labels"] = np.full_like(batch["labels"], -1)
    jl, _ = reference(arch, batch)
    zl, zg = port_loss_and_grads(_configs(arch)[1], _weights(arch)[1], batch)
    assert float(zl) == 0.0 and float(jl) == 0.0
    assert all(not bool(g.any()) for _, g in pt_params.tree_leaves(zg))


@pytest.mark.parametrize("arch", ARCHS)
def test_recomputation_changes_no_bit(arch):
    cfg = pt_configs.get_smoke(arch)
    params = _weights(arch)[1]
    batch = _batch(cfg, 3)
    l_on, g_on = port_loss_and_grads(cfg, params, batch, remat=True)
    l_off, g_off = port_loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(l_on, l_off)
    off = dict(pt_params.tree_leaves(g_off))
    for path, g in pt_params.tree_leaves(g_on):
        assert torch.equal(g, off[path]), path


def _padded_vocab(cfg):
    # tp = 8 pads the vocabulary 250 -> 256 and the heads (alike in both)
    return dataclasses.replace(cfg, vocab=250, tp=8)


def test_padded_vocabulary_columns_get_zero_gradient(reference):
    arch = "qwen2.5-3b"
    jcfg, pcfg = _configs(arch, _padded_vocab)
    assert pt_params.vocab_padded(pcfg) == 256 > pcfg.vocab
    assert jx_params.vocab_padded(jcfg) == 256
    batch = _batch(pcfg, 4, masked=True)
    jl, jg = reference(arch, batch, _padded_vocab)
    pl, pg = port_loss_and_grads(pcfg, _weights(arch, _padded_vocab)[1],
                                 batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL_LOSS)
    _hold_grads(pg, jg, "padded vocabulary")
    # tied embeddings: the padded rows feed only the masked columns
    assert not bool(pg["embed"][pcfg.vocab:].any())
    assert not np.asarray(jg["embed"])[pcfg.vocab:].any()
    assert bool(pg["embed"][:pcfg.vocab].any())


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def test_bf16_loss_and_grads_match_reference(reference):
    arch = "qwen2.5-3b"
    _, pcfg = _configs(arch, _bf16)
    batch = _batch(pcfg, 5, masked=True)
    jl, jg = reference(arch, batch, _bf16)
    pl, pg = port_loss_and_grads(pcfg, _weights(arch, _bf16)[1], batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL_BF16_LOSS)
    want = _paths(jg)
    for path, g in pt_params.tree_leaves(pg):
        assert g.dtype == torch.bfloat16, path
        w = _np(want[path])
        rms = float(np.sqrt(np.mean(np.square(w))))
        err = float(np.abs(_np(g) - w).max())
        assert err <= TOL_BF16_RMS * rms, (path, err, rms)
