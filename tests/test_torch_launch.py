"""The port's launch layer (``repro_torch.launch.cells``,
``repro_torch.launch.hlo_analysis``, ``repro_torch.launch.roofline``)
against the JAX reference's on the CPU (the meshes of ``launch_pairs.py``:
forced host devices for the reference, ``"cpu"`` listed as often for the
port). Held:
  - ``test_launch_units.py``'s unit checks on the port's modules: the cell
    list (the reference's 33 pairs in its order), ``SHAPES``, ``LONG_OK``,
    ``BIG_ARCHS``; the roofline terms with the H100's constants;
    ``combine_costs``; ``model_flops`` equal to the reference's;
  - every one of the 66 cells (33 x single and multi pod), exactly: kind,
    donated arguments, ``meta`` (rules stringified as the reference does),
    every leaf of ``args`` and ``kwargs`` (shape, dtype, ``PartitionSpec``),
    the probes' labels and multipliers and every leaf of their abstract
    arguments;
  - probe outputs on the ``meta`` device against ``jax.eval_shape`` of the
    reference's probe, shape and dtype, for the probes that cost well
    under a second on meta (``test_torch_launch_probes.py`` holds the
    others, ``test_torch_launch_values.py`` probe values);
  - whole steps' outputs against ``jax.eval_shape``: a dense train cell
    (accum 1), a dense prefill, an MoE decode and an enc-dec prefill, the
    port's steps built over a mesh of the ``meta`` device;
  - collective bytes against the reference's own ``collective_bytes`` of
    the reference program compiled on the forced host devices, the whole
    dict exactly: ``tree_compressed_mean`` over 2 and 4 pods, the
    compressed train step, the expert-parallel MoE over (data, model)
    meshes, the sharded mask build (nothing in either); the reference's
    loop-multiplication fixture through the port's crossing points;
    recording changes no output bitwise.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JxMesh  # noqa: E402
from jax.sharding import PartitionSpec as JxP  # noqa: E402

from launch_pairs import (CELLS, MESHES, cells_pair, hold_leaves,  # noqa: E402
                          jx_mesh, probe_outputs_match, slow_on_meta)
from repro import configs as jx_configs  # noqa: E402
from repro.aqp import executor as jx_exec  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro.distributed import compression as jx_comp  # noqa: E402
from repro.launch import cells as jx_cells  # noqa: E402
from repro.launch import hlo_analysis as jx_hlo  # noqa: E402
from repro.launch import roofline as jx_roof  # noqa: E402
from repro.models import ffn as jx_ffn  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro.models.common import ShardCtx as JxShardCtx  # noqa: E402
from repro.training import optimizer as jx_opt  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.distributed import compression as pt_comp  # noqa: E402
from repro_torch.distributed import sharding as pt_sh  # noqa: E402
from repro_torch.launch import cells as pt_cells  # noqa: E402
from repro_torch.launch import hlo_analysis as pt_hlo  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch import roofline as pt_roof  # noqa: E402
from repro_torch.models import ffn as pt_ffn  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.models.common import ShardCtx as PtShardCtx  # noqa: E402
from repro_torch.training import optimizer as pt_opt  # noqa: E402


# ------------------------------------------------ test_launch_units mirror
def test_cell_list_policy():
    cells = pt_cells.cell_list()
    assert len(cells) == 33  # 10 archs x 3 shapes + 3 long_500k
    assert cells == jx_cells.cell_list()
    longs = {a for a, s in cells if s == "long_500k"}
    assert longs == pt_cells.LONG_OK == jx_cells.LONG_OK
    assert set(pt_cells.SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                    "long_500k"}
    assert pt_cells.SHAPES == jx_cells.SHAPES
    assert pt_cells.BIG_ARCHS == jx_cells.BIG_ARCHS


def test_roofline_terms_and_dominance():
    r = pt_roof.roofline(989e12, 3.35e12 * 2, 900e9 * 0.5)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(0.5)
    assert r["dominant"] == "memory_s"
    assert r["roofline_fraction"] == pytest.approx(0.5)


def test_combine_costs():
    tot = pt_roof.combine_costs({"flops": 10.0, "bytes accessed": 100.0},
                                [(3, {"flops": 2.0, "bytes accessed": 5.0})])
    assert tot["flops_per_device"] == 16.0
    assert tot["bytes_per_device"] == 115.0


def test_model_flops():
    cfg = pt_configs.get("qwen2.5-3b")
    mf = pt_roof.model_flops(cfg, "train", 4096, 256)
    assert mf == pytest.approx(6 * cfg.n_params * 4096 * 256)
    moe = pt_configs.get("arctic-480b")
    assert moe.n_active_params < 0.1 * moe.n_params  # top-2 of 128 + dense
    for arch, shape in CELLS:
        info = pt_cells.SHAPES[shape]
        assert pt_roof.model_flops(
            pt_configs.get(arch), info["kind"], info["seq"], info["batch"]
        ) == jx_roof.model_flops(jx_configs.get(arch), info["kind"],
                                 info["seq"], info["batch"])


def test_production_meshes_of_the_meta_device():
    for mp, shape in ((False, {"data": 16, "model": 16}),
                      (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=mp, device="meta")
        assert mesh.shape == shape
        assert set(mesh.devices) == {torch.device("meta")}


# ----------------------------------------------------------------- 66 cells
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_cells_equal_the_reference(arch, shape, multi_pod, forced_devices):
    forced_devices(8)
    want, got = cells_pair(arch, shape, multi_pod)
    what = f"{arch} {shape} pod2={multi_pod}"
    assert (got.arch, got.shape, got.kind) == (want.arch, want.shape,
                                               want.kind)
    assert got.donate == want.donate, what
    assert got.meta == want.meta, (what, got.meta, want.meta)
    hold_leaves(got.args, want.args, what)
    hold_leaves(got.kwargs, want.kwargs, what)
    assert [(p[0], p[1]) for p in got.probes] == \
        [(p[0], p[1]) for p in want.probes], what
    for (label, _, _, g), (_, _, _, w) in zip(got.probes, want.probes):
        hold_leaves(g, w, f"{what} {label}")
    assert got.cfg.tp == want.cfg.tp


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_quick_probe_outputs_match_eval_shape(arch, shape, forced_devices):
    forced_devices(8)
    labels = [p[0] for p in cells_pair(arch, shape, False)[1].probes
              if not slow_on_meta(arch, shape, p[0])]
    probe_outputs_match(arch, shape, labels)


# ------------------------------------------------------------- whole steps
WHOLE = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "prefill_32k"),
         ("arctic-480b", "decode_32k"), ("seamless-m4t-medium", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", WHOLE, ids=[f"{a}-{s}"
                                                   for a, s in WHOLE])
def test_whole_step_outputs_match_eval_shape(arch, shape, forced_devices):
    forced_devices(8)
    accum = 1 if shape == "train_4k" else None
    shape_, axes = MESHES[False]
    jm = jx_mesh(False)
    pm = pt_exec.Mesh(("meta",) * 8, axes, shape_)  # the step runs on meta
    want_cell = jx_cells.build_cell(arch, shape, jm, False, accum=accum)
    cell = pt_cells.build_cell(arch, shape, pm, False, accum=accum)
    hold_leaves(cell.args, want_cell.args, arch)
    want = jax.eval_shape(want_cell.step, *want_cell.args,
                          **want_cell.kwargs)
    got = cell.step(*pt_cells.call_args(cell.args, pos=7),
                    **pt_cells.materialize(cell.kwargs))
    hold_leaves(pt_cells.abstract(got), want, f"{arch} {shape}",
                specs=False)


# -------------------------------------------------------------- collectives
def _jx_collectives(fn, *args):
    return jx_hlo.collective_bytes(jax.jit(fn).lower(*args).compile()
                                   .as_text())


def _hold_dict(got, want):
    assert got == want, (got, want)


@pytest.mark.parametrize("pods", [2, 4])
def test_tree_compressed_mean_collectives_equal_the_reference(
        pods, forced_devices):
    jm = JxMesh(np.array(forced_devices(pods)), ("pod",))
    pm = pt_exec.Mesh(("cpu",) * pods, ("pod",))
    rng = np.random.default_rng(pods)
    a = rng.normal(size=(pods, 64, 32)).astype(np.float32)
    b = rng.normal(size=(pods, 100)).astype(np.float32)
    want = _jx_collectives(jax.shard_map(
        lambda t: jx_comp.tree_compressed_mean(t, "pod"), mesh=jm,
        in_specs=JxP("pod"), out_specs=JxP("pod"), check_vma=False),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)})
    assert want["bytes_by_kind"] == {"collective-permute": 2156.0}
    assert want["op_counts"] == {"collective-permute": 4}
    trees = [{"a": torch.from_numpy(a[i:i + 1]),
              "b": torch.from_numpy(b[i:i + 1])} for i in range(pods)]
    with pt_hlo.record_collectives() as rec:
        pt_comp.tree_compressed_mean(trees, pm)
    _hold_dict(pt_hlo.collective_bytes(rec), want)


def _smoke_weights(arch):
    cfg = jx_configs.get_smoke(arch)
    jp = jax.jit(functools.partial(jx_params.init_params, cfg))(
        jax.random.PRNGKey(0))
    pp = pt_params.params_from_jax(pt_configs.get_smoke(arch),
                                   jax.tree.map(np.asarray, jp), device="cpu")
    return jp, pp


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 2)], ids=str)
def test_compressed_step_collectives_equal_the_reference(shape,
                                                         forced_devices):
    arch = "qwen2.5-3b"
    n = int(np.prod(shape))
    axes = ("pod", "data", "model")
    jm = JxMesh(np.array(forced_devices(n)).reshape(shape), axes)
    pm = pt_exec.Mesh(("cpu",) * n, axes, shape)
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _smoke_weights(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (1, 4, 9)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jo, po = jx_opt.adamw(), pt_opt.adamw()
    want = _jx_collectives(
        jx_comp.make_compressed_train_step(jcfg, jo, jm), jp, jo.init(jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(1e-3))
    assert want["op_counts"] == {"all-reduce": 1, "collective-permute": 28}
    step = pt_comp.make_compressed_train_step(pcfg, po, pm)
    with pt_hlo.record_collectives() as rec:
        step(pp, po.init(pp), {k: torch.from_numpy(v).long()
                               for k, v in batch.items()}, torch.tensor(1e-3))
    _hold_dict(pt_hlo.collective_bytes(rec), want)


def _moe_layer(arch):
    jp, pp = _smoke_weights(arch)
    j = jax.tree.map(lambda a: a[0], jp["groups"][0]["sub0"]["moe"])
    p = pt_params.tree_map(lambda t: t[0], pp["groups"][0]["sub0"]["moe"])
    return j, p


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)], ids=str)
def test_moe_collectives_equal_the_reference(shape, forced_devices):
    arch = "arctic-480b"
    n = int(np.prod(shape))
    jm = JxMesh(np.array(forced_devices(n)).reshape(shape),
                ("data", "model"))
    pm = pt_exec.Mesh(("cpu",) * n, ("data", "model"), shape)
    jcfg, pcfg = jx_configs.get_smoke(arch), pt_configs.get_smoke(arch)
    jp, pp = _moe_layer(arch)
    x = np.random.default_rng(5).normal(
        size=(4, 8, jcfg.d_model)).astype(np.float32)
    want = _jx_collectives(functools.partial(
        jx_ffn.moe_ffn, jcfg, sctx=JxShardCtx(mesh=jm)), jp, jnp.asarray(x))
    assert want["op_counts"] == {"all-reduce": 1}
    with pt_hlo.record_collectives() as rec:
        pt_ffn.moe_ffn(pcfg, pp, torch.from_numpy(x), PtShardCtx(mesh=pm))
    got = pt_hlo.collective_bytes(rec)
    _hold_dict(got, want)
    # (4 x 8 / data) rows x d_model in the compute dtype, wire factor 2
    rows = 4 * 8 // shape[0]
    assert got["bytes_by_kind"]["all-reduce"] == rows * pcfg.d_model * 4
    assert got["wire_bytes_total"] == 2 * rows * pcfg.d_model * 4


def test_sharded_mask_build_crosses_nothing_in_either(forced_devices):
    schema = dict(num_lo=(0.0, 0.0), num_hi=(10.0, 10.0), cat_sizes=(4,),
                  n_measures=2)
    kw = dict(agg=[0, 1], measure=[0, 1],
              num_ranges=[{0: (1.0, 4.0)}, {1: (2.0, 9.0)}],
              cat_sets=[{0: (0, 2)}, {}])
    rng = np.random.default_rng(0)
    num = rng.uniform(0, 1, (100, 2))
    cat = rng.integers(0, 4, (100, 1)).astype(np.int32)
    jm = JxMesh(np.array(forced_devices(4)), ("data",))
    jsn = jx_types.pad_snippets(jx_types.make_snippets(
        jx_types.Schema(**schema), **kw))
    jnum, jcat, _, jvalid = jx_exec.pad_tuple_axis(
        4, jnp.asarray(num), jnp.asarray(cat), None)
    want = _jx_collectives(jx_exec._sharded_mask_fn(jm, "data"), jnum, jcat,
                           jvalid, jsn)
    psn = pt_types.pad_snippets(pt_types.make_snippets(
        pt_types.Schema(**schema), **kw))
    with pt_hlo.record_collectives() as rec:
        pt_exec.sharded_mask(pt_exec.Mesh(("cpu",) * 4), torch.as_tensor(num),
                             torch.as_tensor(cat), psn)
    got = pt_hlo.collective_bytes(rec)
    assert want["wire_bytes_total"] == got["wire_bytes_total"] == 0.0
    _hold_dict(got, want)


def test_collectives_in_a_loop_multiply_by_its_trips():
    """The reference's loop-multiplication fixture (an all-gather of a
    (16, 16) float32 array, an all-reduce of an (8, 16) one in a 12-trip
    loop), through the port's crossing points: ``ShardCtx.use_weights``
    gathering a weight split over two positions, and twelve reports."""
    mesh = pt_exec.Mesh(("cpu",) * 2, ("data", "model"), (2, 1))
    w = pt_sh.device_put(torch.ones(16, 16),
                         pt_sh.named(mesh, "data", None))
    part = torch.zeros(8, 16)
    with pt_hlo.record_collectives() as rec:
        got = PtShardCtx(mesh=mesh, gather_weights=True).use_weights(
            {"w": w})
        for _ in range(12):
            pt_sh.report_collective("all-reduce", part)
    assert torch.equal(got["w"], torch.ones(16, 16))
    out = pt_hlo.collective_bytes(rec)
    want = jx_hlo.collective_bytes(
        open(__file__.replace("test_torch_launch.py",
                              "test_launch_units.py")).read()
        .split('HLO = """')[1].split('"""')[0])
    _hold_dict(out, want)
    assert out["bytes_by_kind"]["all-gather"] == 1024
    assert out["bytes_by_kind"]["all-reduce"] == 512 * 12
    assert out["wire_bytes_by_kind"]["all-reduce"] == 512 * 12 * 2
    assert out["op_counts"]["all-reduce"] == 12
    # a replicated weight is not gathered: nothing crosses
    rep = pt_sh.device_put(torch.ones(4), pt_sh.named(mesh))
    with pt_hlo.record_collectives() as rec:
        PtShardCtx(mesh=mesh, gather_weights=True).use_weights({"w": rep})
    assert rec == []


def test_recording_changes_no_output_and_ends_with_its_block():
    arch = "arctic-480b"
    pcfg = pt_configs.get_smoke(arch)
    _, pp = _moe_layer(arch)
    pm = pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (2, 2))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 8, pcfg.d_model)).astype(np.float32))
    plain = pt_ffn.moe_ffn(pcfg, pp, x, PtShardCtx(mesh=pm))
    trees = [{"a": x[i]} for i in range(2)]
    plain_mean = pt_comp.tree_compressed_mean(trees, pt_exec.Mesh(
        ("cpu",) * 2, ("pod",)))
    with pt_hlo.record_collectives() as outer:
        with pt_hlo.record_collectives() as inner:
            heard = pt_ffn.moe_ffn(pcfg, pp, x, PtShardCtx(mesh=pm))
            mean = pt_comp.tree_compressed_mean(trees, pt_exec.Mesh(
                ("cpu",) * 2, ("pod",)))
    assert torch.equal(heard, plain)
    for a, b in zip(pt_params.tree_leaves(list(mean)),
                    pt_params.tree_leaves(list(plain_mean))):
        assert torch.equal(a[1], b[1])
    assert outer == inner and len(inner) == 3
    assert pt_sh.COLLECTIVE_LISTENERS == []
    with pytest.raises(ValueError):
        with pt_hlo.record_collectives():
            pt_sh.report_collective("all-to-everyone", x)
    assert pt_sh.COLLECTIVE_LISTENERS == []


def test_dtype_bytes_table_matches_the_reference():
    names = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
             "s16": torch.int16, "u16": torch.uint16, "bf16": torch.bfloat16,
             "f16": torch.float16, "s32": torch.int32, "u32": torch.uint32,
             "f32": torch.float32, "s64": torch.int64, "u64": torch.uint64,
             "f64": torch.float64, "f8e4m3fn": torch.float8_e4m3fn,
             "f8e5m2": torch.float8_e5m2}
    assert set(names) == set(jx_hlo.DTYPE_BYTES)
    for name, dt in names.items():
        assert pt_hlo.DTYPE_BYTES[dt] == jx_hlo.DTYPE_BYTES[name], name
    assert set(pt_hlo.DTYPE_BYTES) == set(names.values())
    # test_shape_bytes_tuple_and_dtypes' cases
    assert pt_hlo.tensor_bytes(torch.zeros(2, 3, dtype=torch.bfloat16)) + \
        pt_hlo.tensor_bytes(torch.zeros(4)) == jx_hlo._shape_bytes(
            "(bf16[2,3], f32[4])") == 2 * 3 * 2 + 4 * 4
    assert pt_hlo.tensor_bytes(torch.zeros(10, dtype=torch.int8)) == 10
    assert pt_hlo.tensor_bytes(torch.zeros((), dtype=torch.bool)) == 1
    assert pt_hlo.COLLECTIVES == jx_hlo.COLLECTIVES
    assert pt_hlo.WIRE_FACTOR == jx_hlo.WIRE_FACTOR


def test_launch_modules_import_no_jax():
    import ast
    import pathlib

    root = pathlib.Path(pt_cells.__file__).parent
    for name in ("cells.py", "hlo_analysis.py"):
        tree = ast.parse((root / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "repro"), (name, m)


def test_device_bytes_of_a_cell():
    cell = pt_cells.build_cell("qwen2.5-3b", "decode_32k",
                               make_production_mesh(device="meta"), False)
    k = cell.args[1][0]["sub0"]["attn"]["k"]
    # (36 layers, 128 batch, 32,784 slots, 2 kv heads, 128): batch over 16
    assert k.shape == (36, 128, 32784, 2, 128)
    assert pt_cells.device_bytes(k) == 36 * 8 * 32784 * 2 * 128 * 2
    assert dataclasses.is_dataclass(cell)
