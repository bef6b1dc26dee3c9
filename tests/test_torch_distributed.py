"""The port's distributed layer (``repro_torch.distributed``, the mesh with
named axes, ``ShardCtx(mesh=...)`` and the expert-parallel MoE) against
the JAX reference's on the CPU.

The reference's meshes are made of the forced host devices
(``forced_devices``, conftest.py); the port's list ``"cpu"`` as many
times, with the same axis names and sizes. Tolerances:
  - sharding trees (``params.shardings`` under the three rule sets for the
    ten full configs after ``with_tp(4)``, ``opt_state_shardings`` for
    AdamW and Adafactor, ``cache_shardings`` for the ten smoke configs,
    ``batch_sharding``, ``data_shards``): the same ``PartitionSpec``
    tuples, leaf by leaf, exactly;
  - ``NamedSharding.devices_indices_map``: the reference's slices for the
    device at each mesh position, exactly; ``device_get(device_put(x))``
    bitwise x;
  - the expert-parallel MoE against the reference's ``shard_map`` MoE on
    the same (data, model) mesh, float32: rtol 1e-5 / atol 1e-5 (the
    single-device MoE parity test's; products summed in another order),
    also at a capacity factor of 1.0, where the local capacity drops
    tokens; the whole model's logits at the LM tests' rtol 1e-5 / atol
    1e-4; the single-device MoE and a one-position mesh bitwise;
  - ``quantize_int8``: ``q`` exactly at every element whose |x| / scale
    lies farther than 1e-4 from a half-integer, the scale within one
    float32 ulp; the error-feedback bound of the reference's test;
  - the compressed train step against the reference's on qwen-smoke at
    (pod 2, data 2, model 2) and (pod 4, data 2, model 1), AdamW at lr
    1e-3: each pod's int8 payload exactly away from rounding edges (the
    edge elements counted, at most 0.1% of them), the loss within rtol
    1e-5, ``grad_norm`` within rtol 1e-4, and every parameter within 0.2
    lr (the train step tests' rule for elements whose gradient lies
    within a few eps of 0) plus one lr at the counted edge elements;
    arctic-smoke, where the reference itself fails on JAX 0.9.0 (a
    shard_map nested in a partial-manual one), against the port's own
    exact two-pod mean: every element of the mean the optimizer gets
    within (scale_0 + scale_1) / 4 (1 + 1e-4) of it;
  - the scan over one named axis of a (data, model) mesh: bitwise the
    one-axis mesh of that axis' size.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JxMesh  # noqa: E402

from repro import configs as jx_configs  # noqa: E402
from repro.distributed import compression as jx_comp  # noqa: E402
from repro.distributed import sharding as jx_sh  # noqa: E402
from repro.models import ffn as jx_ffn  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.models import transformer as jx_T  # noqa: E402
from repro.models.common import ShardCtx as JxShardCtx  # noqa: E402
from repro.training import optimizer as jx_opt  # noqa: E402
from repro.training.losses import lm_loss as jx_lm_loss  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.distributed import compression as pt_comp  # noqa: E402
from repro_torch.distributed import sharding as pt_sh  # noqa: E402
from repro_torch.models import ffn as pt_ffn  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.models import transformer as pt_T  # noqa: E402
from repro_torch.models.common import ShardCtx as PtShardCtx  # noqa: E402
from repro_torch.training import optimizer as pt_opt  # noqa: E402
from repro_torch.training import train_loop as pt_loop  # noqa: E402

ARCHS = jx_configs.names()
RULES = {"default": "DEFAULT_RULES", "fsdp": "FSDP_RULES",
         "pure_dp": "PURE_DP_RULES"}
TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3


def _meshes(forced_devices, shape, axes):
    """(the reference's mesh of forced host devices, the port's of the
    CPU listed as many times)."""
    n = int(np.prod(shape))
    jm = JxMesh(np.array(forced_devices(n)).reshape(shape), axes)
    return jm, pt_exec.Mesh(("cpu",) * n, axes, shape)


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jx_paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(_key(k) for k in path): leaf for path, leaf in flat}


def _pt_paths(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)) and not isinstance(
                t, pt_sh.PartitionSpec):
            for i, v in enumerate(t):
                walk(v, f"{prefix}.{i}" if prefix else str(i))
        else:
            out[prefix] = t

    walk(tree, "")
    return out


def _is_jx_sharding(x):
    return isinstance(x, jax.sharding.NamedSharding)


def _hold_specs(got, want, what):
    got = _pt_paths(got)
    want = _jx_paths(want, is_leaf=_is_jx_sharding)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:4])
    for path, w in want.items():
        assert isinstance(got[path], pt_sh.NamedSharding), (what, path)
        assert tuple(got[path].spec) == tuple(w.spec), (what, path,
                                                        got[path].spec, w.spec)


def _hold_index_map(pt_s, jx_s, jm, shape):
    """The port's index map by mesh position equals the reference's for
    the device at that position (or both refuse the shape)."""
    try:
        want = jx_s.devices_indices_map(tuple(shape))
    except ValueError:
        with pytest.raises(ValueError):
            pt_s.devices_indices_map(tuple(shape))
        return
    got = pt_s.devices_indices_map(tuple(shape))
    for pos, dev in enumerate(jm.devices.flat):
        assert got[pos] == want[dev], (shape, pos, got[pos], want[dev])


# ------------------------------------------------------------ sharding trees
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_the_reference(arch, rules, forced_devices):
    jm, pm = _meshes(forced_devices, (2, 4), ("data", "model"))
    jcfg = jx_configs.get(arch).with_tp(4)
    pcfg = pt_configs.get(arch).with_tp(4)
    want = jx_params.shardings(jcfg, jm, getattr(jx_sh, RULES[rules]))
    got = pt_params.shardings(pcfg, pm, getattr(pt_sh, RULES[rules]))
    _hold_specs(got, want, f"{arch} {rules}")
    # every leaf's index map, at its full-size shape
    shapes = {p: tuple(s.shape) for p, s in _pt_paths(
        pt_params.abstract_params(pcfg)).items()}
    want, got = _jx_paths(want, _is_jx_sharding), _pt_paths(got)
    for path, shape in shapes.items():
        _hold_index_map(got[path], want[path], jm, shape)
    abstract = _pt_paths(pt_params.abstract_params(pcfg, pm,
                                                   getattr(pt_sh,
                                                           RULES[rules])))
    jx_abstract = _jx_paths(jx_params.abstract_params(
        jcfg, jm, getattr(jx_sh, RULES[rules])))
    for path, a in abstract.items():
        assert a.shape == jx_abstract[path].shape, path
        assert str(a.dtype).split(".")[-1] == str(jx_abstract[path].dtype)
        assert tuple(a.sharding.spec) == tuple(
            jx_abstract[path].sharding.spec), path


def _meta_params(cfg):
    dtype = pt_params.torch_dtype(cfg.param_dtype)
    return pt_params.tree_map(
        lambda p: torch.empty(p.shape, dtype=dtype, device="meta"),
        pt_params.param_specs(cfg))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_shardings_equal_the_reference(arch, opt, forced_devices):
    jm, pm = _meshes(forced_devices, (2, 4), ("data", "model"))
    jcfg = jx_configs.get(arch).with_tp(4)
    pcfg = pt_configs.get(arch).with_tp(4)
    for rules in RULES.values():
        jps = jx_params.shardings(jcfg, jm, getattr(jx_sh, rules))
        pps = pt_params.shardings(pcfg, pm, getattr(pt_sh, rules))
        jstate = jax.eval_shape(getattr(jx_opt, opt)().init,
                                jx_params.abstract_params(jcfg))
        pstate = getattr(pt_opt, opt)().init(_meta_params(pcfg))
        _hold_specs(pt_sh.opt_state_shardings(opt, pps, pstate),
                    jx_sh.opt_state_shardings(opt, jps, jstate),
                    f"{arch} {opt} {rules}")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_the_reference(arch, multi_pod,
                                             forced_devices):
    shape, axes = ((2, 2, 2), ("pod", "data", "model")) if multi_pod \
        else ((2, 4), ("data", "model"))
    jm, pm = _meshes(forced_devices, shape, axes)
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    plan = jcfg.decoder_plan() if jcfg.enc_dec else jcfg.layer_plan()
    n_ctx = jcfg.cross_attn.n_ctx if jcfg.cross_attn else \
        (8 if jcfg.enc_dec else 0)
    jc = jax.eval_shape(lambda: jx_T.init_cache(jcfg, plan, 4, 16, n_ctx))
    pc = pt_T.init_cache(pcfg, plan, 4, 16, n_ctx, device="meta")
    for seq_axis in (None, "data", "model"):
        for batch_sharded in (True, False):
            kw = dict(seq_axis=seq_axis, batch_sharded=batch_sharded)
            try:
                want = jx_sh.cache_shardings(jm, multi_pod, jc, jcfg, **kw)
            except Exception as e:  # noqa: BLE001 — DuplicateSpecError
                # an axis for both the batch and the sequence: both refuse
                assert "duplicate" in str(e), e
                with pytest.raises(ValueError, match="twice"):
                    pt_sh.cache_shardings(pm, multi_pod, pc, pcfg, **kw)
                continue
            _hold_specs(pt_sh.cache_shardings(pm, multi_pod, pc, pcfg, **kw),
                        want, f"{arch} {kw}")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_sharding_and_data_shards(multi_pod, forced_devices):
    jm, pm = _meshes(forced_devices, (2, 2, 2), ("pod", "data", "model"))
    assert pt_sh.batch_axes(multi_pod) == jx_sh.batch_axes(multi_pod)
    assert pt_sh.data_shards(pm, multi_pod) == \
        jx_sh.data_shards(jm, multi_pod)
    for ndim, dim in ((2, 0), (3, 1)):
        got = pt_sh.batch_sharding(pm, multi_pod, ndim, dim)
        want = jx_sh.batch_sharding(jm, multi_pod, ndim, dim)
        assert tuple(got.spec) == tuple(want.spec)
        _hold_index_map(got, want, jm, (8,) * ndim)
    assert pt_sh.DEFAULT_RULES == jx_sh.DEFAULT_RULES
    assert pt_sh.FSDP_RULES == jx_sh.FSDP_RULES
    assert pt_sh.PURE_DP_RULES == jx_sh.PURE_DP_RULES


# ------------------------------------------------------- device_put / get
SPECS = [(), (None,), ("data",), ("model", "data"), (("pod", "data"), None),
         (None, ("model", "pod")), ("pod", None, "model"),
         (("data", "model", "pod"),)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_device_put_index_maps_and_round_trip(spec, forced_devices):
    jm, pm = _meshes(forced_devices, (2, 2, 2), ("pod", "data", "model"))
    shape = (8, 4, 6)[:max(len(spec), 1)]
    jx_s = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec))
    pt_s = pt_sh.named(pm, *spec)
    _hold_index_map(pt_s, jx_s, jm, shape)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))
    placed = pt_sh.device_put(x, pt_s)
    jx_placed = jax.device_put(x.numpy(), jx_s)
    by_dev = {s.device: np.asarray(s.data)
              for s in jx_placed.addressable_shards}
    for pos, dev in enumerate(jm.devices.flat):
        np.testing.assert_array_equal(placed.shards[pos].numpy(),
                                      by_dev[dev])
    # every shard owns its storage: replicas never alias
    ptrs = [s.untyped_storage().data_ptr() for s in placed.shards]
    assert len(set(ptrs)) == len(ptrs)
    assert torch.equal(pt_sh.device_get(placed), x)
    again = pt_sh.device_put(placed, pt_sh.named(pm, *SPECS[2]))
    assert torch.equal(pt_sh.device_get(again), x)


def test_named_sharding_refuses_what_jax_refuses():
    pm = pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (2, 2))
    with pytest.raises(ValueError):
        pt_sh.named(pm, "pod")
    with pytest.raises(ValueError):
        pt_sh.named(pm, "data", "data")
    with pytest.raises(ValueError):
        pt_sh.named(pm, "data").devices_indices_map((3,))
    with pytest.raises(ValueError):
        pt_sh.named(pm, "data", None).devices_indices_map((4,))


# ------------------------------------------------------------------- mesh
def test_mesh_axes_coordinates_and_sub_meshes():
    one = pt_exec.Mesh(("cpu",) * 4)
    assert one.axis_names == ("data",) and one.shape == {"data": 4}
    m = pt_exec.Mesh(tuple(f"cpu:{i}" for i in range(8)),
                     ("pod", "data", "model"), (2, 2, 2))
    assert m.shape == {"pod": 2, "data": 2, "model": 2} and m.size == 8
    for pos in range(8):
        assert m.position(m.coords(pos)) == pos
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert m.device_at({"pod": 1, "model": 1}) == torch.device("cpu", 5)
    sub = m.sub_mesh("pod", 1)
    assert sub.axis_names == ("data", "model")
    assert [d.index for d in sub.devices] == [4, 5, 6, 7]
    assert [d.index for d in m.sub_mesh("model", 1).devices] == [1, 3, 5, 7]
    assert [d.index for d in m.axis_devices("data")] == [0, 2]
    with pytest.raises(ValueError):
        pt_exec.Mesh(("cpu",) * 4, ("data", "model"))
    with pytest.raises(ValueError):
        pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (2, 3))
    with pytest.raises(IndexError):
        m.position({"pod": 2})


def _scan_inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    schema = pt_types.Schema(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0),
                             cat_sizes=(3, 4), n_measures=2)
    num = torch.as_tensor(rng.uniform(0, 1, (t, 2)))
    cat = torch.as_tensor(np.stack([rng.integers(0, s, t) for s in (3, 4)],
                                   1).astype(np.int32))
    meas = torch.as_tensor(rng.normal(1.0, 2.0, (t, 2)))
    ranges = [{0: (a, a + 3.0)} for a in np.linspace(0.0, 6.0, 5)]
    cats = [{1: (0, 2)}, {}, {0: (1, 1)}, {}, {1: (3, 3)}]
    snips = pt_types.pad_snippets(pt_types.make_snippets(
        schema, agg=[0, 1, 0, 1, 0], measure=[0, 1, 1, 0, 1],
        num_ranges=ranges, cat_sets=cats))
    return num, cat, meas, snips


@pytest.mark.parametrize("t", [1000, 1023])
@pytest.mark.parametrize("axis,shape", [("data", (2, 4)), ("model", (2, 4)),
                                        ("data", (4, 1))])
def test_scan_over_one_axis_of_a_two_axis_mesh_is_the_one_axis_mesh(
        t, axis, shape):
    num, cat, meas, snips = _scan_inputs(t)
    two = pt_exec.Mesh(("cpu",) * int(np.prod(shape)), ("data", "model"),
                       shape)
    one = pt_exec.Mesh(("cpu",) * two.shape[axis])
    got = pt_exec.eval_partials_sharded(two, num, cat, meas, snips,
                                        axis=axis)
    want = pt_exec.eval_partials_sharded(one, num, cat, meas, snips)
    local = pt_exec.eval_partials(num, cat, meas, snips)
    for name in ("sums", "sumsq", "count", "scanned"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name), getattr(local, name)), name
    placement = pt_exec.scan_placement(two, axis)
    assert placement.n_shards == two.shape[axis]
    assert placement.describe() == f"sharded:{two.shape[axis]}x{axis}"
    block = pt_exec.place_shards(two, num, cat, meas[:, 0], axis)
    assert len(block) == two.shape[axis]


# -------------------------------------------------------------------- MoE
@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jx_configs.get_smoke(arch)
    jp = jax.jit(functools.partial(jx_params.init_params, cfg))(
        jax.random.PRNGKey(0))
    pp = pt_params.params_from_jax(pt_configs.get_smoke(arch),
                                   jax.tree.map(np.asarray, jp), device="cpu")
    return jp, pp


MOE_LAYER = {"arctic-480b": (0, 0), "llama4-maverick-400b-a17b": (0, 1)}


def _moe_layer(arch):
    group, sub = MOE_LAYER[arch]
    jp, pp = _weights(arch)
    j, p = jp["groups"][group][f"sub{sub}"], pp["groups"][group][f"sub{sub}"]
    if jx_configs.get_smoke(arch).layer_plan()[group][1] > 1:
        j = jax.tree.map(lambda a: a[0], j)
        p = pt_params.tree_map(lambda t: t[0], p)
    return j["moe"], p["moe"]


def _cfgs(arch, cap):
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    if cap is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=cap))
    return jcfg, pcfg


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("cap", [1.0, 8.0])
@pytest.mark.parametrize("arch", list(MOE_LAYER))
def test_expert_parallel_moe_matches_the_reference(arch, cap, shape,
                                                   forced_devices):
    jm, pm = _meshes(forced_devices, shape, ("data", "model"))
    jcfg, pcfg = _cfgs(arch, cap)
    jp, pp = _moe_layer(arch)
    x = np.random.default_rng(9).normal(
        size=(4, 9, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jx_ffn.moe_ffn, jcfg, sctx=JxShardCtx(mesh=jm)))(jp, jnp.asarray(x)))
    got = pt_ffn.moe_ffn(pcfg, pp, torch.from_numpy(x),
                         PtShardCtx(mesh=pm))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if cap == 1.0:  # the local capacity drops tokens the global one keeps
        single = np.asarray(jx_ffn.moe_ffn(jcfg, jp, jnp.asarray(x),
                                           JxShardCtx()))
        assert shape[0] == 1 or not np.allclose(want, single, **TOL)


@pytest.mark.parametrize("arch", list(MOE_LAYER))
def test_single_device_moe_and_a_one_position_mesh_are_bitwise(arch):
    _, pcfg = _cfgs(arch, 1.0)
    _, pp = _moe_layer(arch)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 9, pcfg.d_model)).astype(np.float32))
    alone = pt_ffn.moe_ffn(pcfg, pp, x)
    mesh = pt_exec.Mesh(("cpu",), ("data", "model"), (1, 1))
    assert torch.equal(pt_ffn.moe_ffn(pcfg, pp, x, PtShardCtx(mesh=mesh)),
                       alone)
    # each batch shard alone is the (2, 1) mesh's shard: same capacity
    two = pt_exec.Mesh(("cpu",) * 2, ("data", "model"), (2, 1))
    halves = torch.cat([pt_ffn.moe_ffn(pcfg, pp, x[i:i + 1])
                        for i in range(2)])
    assert torch.equal(pt_ffn.moe_ffn(pcfg, pp, x, PtShardCtx(mesh=two)),
                       halves)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", list(MOE_LAYER))
def test_model_forward_on_a_mesh_matches_the_reference(arch, shape,
                                                       forced_devices):
    jm, pm = _meshes(forced_devices, shape, ("data", "model"))
    jcfg, pcfg = _cfgs(arch, None)
    jp, pp = _weights(arch)
    tokens = _tokens(jcfg, 2, 8, 4)
    want = np.asarray(jax.jit(functools.partial(
        jx_T.forward, jcfg, sctx=JxShardCtx(mesh=jm)))(
        jp, jnp.asarray(tokens))[0])
    got, _ = pt_T.forward(pcfg, pp, torch.from_numpy(tokens).long(),
                          PtShardCtx(mesh=pm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    alone, _ = pt_T.forward(pcfg, pp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_gathered_fsdp_weights_give_the_plain_forward_bitwise():
    """ZeRO-3 storage: parameters placed under FSDP_RULES on a (data 2,
    model 2) mesh and gathered at use give the forward of the unplaced
    parameters bit for bit."""
    arch = "arctic-480b"
    _, pcfg = _cfgs(arch, None)
    _, pp = _weights(arch)
    pm = pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (2, 2))
    placed = pt_sh.device_put(pp, pt_params.shardings(pcfg, pm,
                                                      pt_sh.FSDP_RULES))
    tokens = torch.from_numpy(_tokens(pcfg, 2, 8, 5)).long()
    sctx = PtShardCtx(mesh=pm, gather_weights=True)
    got, _ = pt_T.forward(pcfg, placed, tokens, sctx)
    want, _ = pt_T.forward(pcfg, pp, tokens, PtShardCtx(mesh=pm))
    assert torch.equal(got, want)
    assert sctx.constrain(got, ("data",), None, "model") is got
    with pytest.raises(ValueError):
        sctx.constrain(got, "pod")


# ---------------------------------------------------------- int8 exchange
def _edge(x, scale, width=1e-4):
    """Elements whose |x| / scale lies within ``width`` of a half
    integer: where two float32 gradients' last bits may round apart."""
    r = np.abs(np.asarray(x, np.float64)) / float(scale)
    return np.abs(r - np.floor(r) - 0.5) < width


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 0.1, (257,)) * 10.0 ** rng.integers(-6, 2)).astype(
        np.float32)
    x[3] = 0.0
    jq, js = jx_comp.quantize_int8(jnp.asarray(x))
    pq, ps = pt_comp.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert abs(float(ps) - float(js)) <= np.spacing(np.float32(js))
    keep = ~_edge(x, js)
    np.testing.assert_array_equal(pq.numpy()[keep], np.asarray(jq)[keep])
    np.testing.assert_array_equal(
        pt_comp.dequantize(pq, ps).numpy(),
        (pq.numpy().astype(np.float32) * np.float32(ps)))
    assert int(pq[3]) == 0


def test_quantize_int8_error_feedback():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.1, (256,)).astype(np.float32))
    q, scale = pt_comp.quantize_int8(x)
    assert q.dtype == torch.int8
    err = x - pt_comp.dequantize(q, scale)
    assert float(torch.max(torch.abs(err))) <= float(scale) * 0.5 + 1e-9


@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_pair_mean_matches_the_reference(pods, forced_devices):
    jm, pm = _meshes(forced_devices, (pods,), ("pod",))
    rng = np.random.default_rng(pods)
    xs = rng.normal(0, 0.1, (pods, 33)).astype(np.float32)

    def body(x):
        m, r = jx_comp.compressed_pair_mean(x[0], "pod")
        return m[None], r[None]

    P = jax.sharding.PartitionSpec
    jm_out, jr_out = jax.jit(jax.shard_map(
        body, mesh=jm, in_specs=P("pod"), out_specs=(P("pod"), P("pod")),
        check_vma=False))(jnp.asarray(xs))
    means, resid = pt_comp.compressed_pair_mean(
        [torch.from_numpy(x) for x in xs], pm)
    for i in range(pods):
        np.testing.assert_allclose(means[i].numpy(), np.asarray(jm_out)[i],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(resid[i].numpy(), np.asarray(jr_out)[i],
                                   rtol=1e-6, atol=1e-7)
    trees = [{"a": torch.from_numpy(x[:20].reshape(4, 5)),
              "b": [torch.from_numpy(x[20:])]} for x in xs]
    tmeans, tresid = pt_comp.tree_compressed_mean(trees, pm)
    for i in range(pods):
        assert tuple(tmeans[i]["a"].shape) == (4, 5)
        assert tmeans[i]["b"][0].dtype == torch.float32
        np.testing.assert_allclose(
            tresid[i]["a"].numpy().ravel(),
            xs[i][:20] - pt_comp.dequantize(
                *pt_comp.quantize_int8(trees[i]["a"])).numpy().ravel(),
            rtol=0, atol=0)


def test_ppermute_moves_each_value_to_its_peer_and_zeros_the_rest():
    pm = pt_exec.Mesh(("cpu",) * 6, ("pod", "data"), (3, 2))
    xs = [{"q": torch.full((2,), i, dtype=torch.int8)} for i in range(3)]
    out = pt_comp.ppermute(xs, pm, "pod", [(0, 1), (1, 2)])
    assert [int(o["q"][0]) for o in out] == [0, 0, 1]
    assert out[0]["q"].dtype == torch.int8


def _watch(monkeypatch):
    """Every payload ``ppermute`` hands between pods, recorded."""
    seen = []
    real = pt_comp.ppermute

    def spy(xs, mesh, axis, perm):
        seen.append((axis, perm, xs))
        return real(xs, mesh, axis, perm)

    monkeypatch.setattr(pt_comp, "ppermute", spy)
    return seen


def _batch(cfg, pods, seed, micro_per_pod=2, s=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (1, micro_per_pod * pods, s + 1))
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


def _jx_pod_grads(jcfg, jp, batch, pods):
    """The reference's float32 gradients of each pod's rows (its
    ``lm_loss`` at the same parameters), leaf by leaf in the port's
    order."""
    rows = batch["tokens"].shape[1] // pods
    fn = jax.jit(jax.value_and_grad(
        lambda p, mb: jx_lm_loss(jcfg, p, mb, JxShardCtx())))
    out = []
    for i in range(pods):
        mb = {k: jnp.asarray(v[0, i * rows:(i + 1) * rows])
              for k, v in batch.items()}
        loss, g = fn(jp, mb)
        out.append((float(loss), _jx_paths(g)))
    return out


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1)], ids=str)
def test_compressed_step_matches_the_reference(shape, forced_devices,
                                               monkeypatch):
    arch = "qwen2.5-3b"
    pods = shape[0]
    jm, pm = _meshes(forced_devices, shape, ("pod", "data", "model"))
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp0, pp = _weights(arch)
    pp = pt_params.tree_map(lambda t: t.clone(), pp)
    jp = jax.tree.map(jnp.array, jp0)
    batch = _batch(jcfg, pods, 7)
    jo, po = jx_opt.adamw(), pt_opt.adamw()
    js, ps = jo.init(jp), po.init(pp)
    jstep = jax.jit(jx_comp.make_compressed_train_step(jcfg, jo, jm))
    jp1, js1, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jnp.float32(LR))
    seen = _watch(monkeypatch)
    step = pt_comp.make_compressed_train_step(pcfg, po, pm)
    out_p, out_s, met = step(
        pp, ps, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        torch.tensor(LR))
    assert out_p is pp and out_s is ps and int(ps["step"]) == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    # one exchange over "pod", int8 payloads and float32 scales only
    ((axis, perm, payloads),) = seen
    assert axis == "pod" and perm == [(i, (i + 1) % pods)
                                      for i in range(pods)]
    ref = _jx_pod_grads(jcfg, jp0, batch, pods)
    paths = [p for p, _ in pt_params.tree_leaves(pp)]
    n_edge = n_all = 0
    edge_of = {p: np.zeros(t.shape, bool) for p, t in
               pt_params.tree_leaves(pp)}
    for i in range(pods):
        _, g = ref[i]
        assert len(payloads[i]) == len(paths)
        for path, (q, scale) in zip(paths, payloads[i]):
            assert q.dtype == torch.int8 and scale.dtype == torch.float32
            assert q.numel() == int(np.prod(edge_of[path].shape))
            jq, js_ = jx_comp.quantize_int8(g[path].astype(jnp.float32))
            assert abs(float(scale) - float(js_)) <= 2 * np.spacing(
                np.float32(js_)) + 1e-6 * float(js_), path
            edge = _edge(g[path], js_)
            n_edge += int(edge.sum())
            n_all += edge.size
            if i in (0, pods - 1):  # what pod 0 averages
                edge_of[path] |= edge
            np.testing.assert_array_equal(q.numpy()[~edge],
                                          np.asarray(jq)[~edge],
                                          err_msg=f"pod {i} {path}")
    assert n_edge <= 0.001 * n_all, (n_edge, n_all)
    want = _jx_paths(jp1)
    for path, t in pt_params.tree_leaves(pp):
        d = np.abs(t.numpy() - np.asarray(want[path]))
        bound = 0.2 * LR + 1e-5 * np.abs(np.asarray(want[path])) \
            + LR * edge_of[path]
        assert (d <= bound).all(), (path, float(d.max()))
    np.testing.assert_allclose(
        _pt_paths(ps["m"])["embed"].numpy(),
        np.asarray(_jx_paths(js1["m"])["embed"]), rtol=1e-4, atol=1e-6)


def test_compressed_moe_step_holds_the_int8_bound(monkeypatch):
    """arctic-smoke on (pod 2, data 1, model 2): the mean the optimizer
    gets lies within the int8 bound of the exact mean of the two pods'
    float32 gradients (each pod's taken over its sub-mesh, expert-parallel
    MoE included), and the loss is the pods' mean."""
    arch = "arctic-480b"
    pcfg = pt_configs.get_smoke(arch)
    _, pp = _weights(arch)
    pp = pt_params.tree_map(lambda t: t.clone(), pp)
    pm = pt_exec.Mesh(("cpu",) * 4, ("pod", "data", "model"), (2, 1, 2))
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(pcfg, 2, 11).items()}
    exact, losses = [], []
    for i in range(2):
        part = {k: v[:, 2 * i:2 * i + 2] for k, v in batch.items()}
        loss, g = pt_loop.accumulated_grads(
            pcfg, pp, part, PtShardCtx(mesh=pm.sub_mesh("pod", i)))
        exact.append([x.float() for x in g])
        losses.append(float(loss))
    seen = _watch(monkeypatch)
    handed = []
    opt = pt_opt.adamw()
    real_update = opt.update

    def spy(grads, state, params, lr):
        handed.append([g.clone() for _, g in pt_params.tree_leaves(grads)])
        return real_update(grads, state, params, lr)

    opt = dataclasses.replace(opt, update=spy)
    state = opt.init(pp)
    step = pt_comp.make_compressed_train_step(pcfg, opt, pm, clip_norm=1e9)
    _, _, met = step(pp, state, batch, torch.tensor(LR))
    assert float(met["loss"]) == pytest.approx(sum(losses) / 2, rel=1e-6)
    ((_, _, payloads),) = seen
    for j, got in enumerate(handed[0]):
        (_, s0), (_, s1) = payloads[0][j], payloads[1][j]
        mean = (exact[0][j] + exact[1][j]) / 2
        bound = (float(s0) + float(s1)) / 4 * (1 + 1e-4)
        assert float((got - mean).abs().max()) <= bound, j
