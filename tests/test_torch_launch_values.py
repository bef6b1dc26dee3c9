"""The launch cells' probes (``repro_torch.launch.cells``) called on
concrete values against the JAX reference's on the CPU: qwen2.5-3b,
rwkv6-3b and hymba-1.5b at train_4k, every probe but the whole model's
``microbatch_vjp`` (``value_and_grad`` of ``lm_loss``, held in
``test_torch_lm_grads.py``), at the probes' own widths with batch and
sequence cut (a layer probe to 2 x 32 tokens, a chunk probe to batch 2), on
the same numpy inputs made from a seed and the same weights. Held:
  - a bfloat16 layer's forward within ``tests/test_torch_lm_bf16.py``'s
    whole-model rule (2**-4 of the reference tensor's RMS, hymba 2**-3,
    plus 2**-7 of each value);
  - its bfloat16 gradients with the same RMS bound on the RMS of the
    difference: element by element each package's bfloat16 gradient lies
    up to ~0.5 of the RMS from the float64 gradient at its worst element,
    the reference's as far as the port's, and in the RMS both lie within
    2**-6 of it;
  - a 0-dim gradient (hymba's fusion scalars, each a bfloat16 sum over
    every position of a layer, which cancels) against the float64
    gradient of the same probe on the same values: no farther from it than
    the reference's, or within ``tests/test_torch_lm_grads.py``'s bfloat16
    rule, 2**-2 of it (at one seed the reference's fuse_s lies 1.07 of the
    float64 value from it, the port's 0.11);
  - the float32 chunk probes within ``tests/test_torch_models.py``'s rtol
    1e-5 / atol 1e-5 for the chunked mixers, on outputs of magnitude ~1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from launch_pairs import cells_pair, jx_paths, key, pt_paths  # noqa: E402
from repro_torch.distributed import sharding as pt_sh  # noqa: E402

RULE = (2.0 ** -4, 2.0 ** -7)  # tests/test_torch_lm_bf16.py's whole-model rule
RULE_RMS = {"hymba-1.5b": 2.0 ** -3}
TOL_F32 = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_models.py's mixers'
TOL_BF16_SUM = 2.0 ** -2  # tests/test_torch_lm_grads.py's bf16 gradient rule


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _concrete(jargs, cut, seed, chunk):
    """The same values as jnp arrays and torch tensors for each leaf of a
    probe's abstract arguments, with ``cut(path, shape)`` giving each
    leaf's shape: floating leaves drawn from a seeded numpy generator
    (weights scaled by 1/sqrt of their first dim, a chunk's inputs by
    1/sqrt of their last, its log decays negative), positions
    ``arange``."""
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(jargs)
    jx, pt = [], []
    for path, a in flat:
        name = ".".join(key(k) for k in path)
        shape = cut(name, tuple(a.shape))
        dt = jnp.dtype(a.dtype)
        if jnp.issubdtype(dt, jnp.integer):
            v = np.broadcast_to(np.arange(shape[-1]), shape).astype(np.int32)
            jx.append(jnp.asarray(v))
            pt.append(torch.from_numpy(v.copy()))
            continue
        v = rng.normal(size=shape).astype(np.float32)
        if name.startswith("1.") and len(shape) >= 2:  # a layer's weight
            v = v / np.sqrt(shape[0])
        if name.startswith("1.") and name.split(".")[-1] in (
                "dec_lambda", "a_log"):
            v = -np.abs(v)
        if chunk:  # outputs of magnitude ~1; log decays negative
            v = -0.5 * np.abs(v) if name == "4" else v / np.sqrt(shape[-1])
        j = jnp.asarray(v, dt)
        jx.append(j)
        pt.append(torch.from_numpy(np.array(j.astype(jnp.float32)))
                  .to(getattr(torch, str(dt))))
    return (jax.tree_util.tree_unflatten(tree, jx),
            jax.tree_util.tree_unflatten(tree, pt))


VALUE_ARCHS = ("qwen2.5-3b", "rwkv6-3b", "hymba-1.5b")
CUT_B, CUT_S = 2, 32


@pytest.mark.parametrize("arch", VALUE_ARCHS)
def test_probe_values_match_the_reference(arch, forced_devices):
    forced_devices(8)
    want, got = cells_pair(arch, "train_4k", False)
    by_label = {p[0]: p for p in want.probes}
    held = []
    for label, _, fn, args in got.probes:
        if label == "microbatch_vjp":
            continue  # the whole model's value_and_grad: test_torch_lm_grads
        _, _, jfn, jargs = by_label[label]
        chunk = label.startswith("ssm_chunk")

        def cut(name, shape, chunk=chunk):
            if name.startswith("1.") and not chunk:  # one layer's weights
                return shape
            if chunk and len(shape) == 2:  # the rwkv bonus u: (H, K)
                return shape
            shape = (CUT_B,) + shape[1:]
            if not chunk and len(shape) >= 2:
                shape = (CUT_B, CUT_S) + shape[2:]
            return shape

        jx_in, pt_in = _concrete(jargs, cut, len(held) + 1, chunk)
        w = jax.tree.map(_np, jax.jit(jfn)(*jx_in))
        g = pt_sh.tree_map(_np, fn(*pt_in))
        wp, gp = jx_paths(w), pt_paths(g)
        exact = None
        if label.endswith("_vjp") and not chunk:  # the float64 gradients
            exact = pt_paths(pt_sh.tree_map(_np, fn(*pt_sh.tree_map(
                lambda t: t.double() if t.is_floating_point() else t,
                pt_in))))
        assert set(wp) == set(gp), (arch, label)
        rule = RULE_RMS.get(arch, RULE[0])
        for path, wv in wp.items():
            gv = gp[path]
            assert gv.shape == wv.shape, (arch, label, path)
            assert np.isfinite(gv).all(), (arch, label, path)
            if chunk:
                np.testing.assert_allclose(gv, wv, err_msg=f"{label} {path}",
                                           **TOL_F32)
                continue
            rms = float(np.sqrt(np.mean(np.square(wv)))) or 1.0
            d = np.abs(gv - wv)
            if exact is not None and wv.size == 1:  # a bf16 sum: vs float64
                t = exact[path]
                assert abs(gv - t) <= max(abs(wv - t),
                                          TOL_BF16_SUM * abs(t)), (
                    arch, label, path, gv, wv, t)
                continue
            if exact is not None:  # bfloat16 gradients: in the RMS
                drms = float(np.sqrt(np.mean(np.square(d))))
                assert drms <= rule * rms, (arch, label, path, drms / rms)
                continue
            bound = rule * rms + RULE[1] * np.abs(wv)
            assert (d <= bound).all(), (arch, label, path,
                                        float((d / rms).max()))
        held.append(label)
    assert held == [p[0] for p in got.probes if p[0] != "microbatch_vjp"]
