"""The port's elastic re-scale (``repro_torch.ft.elastic``), checkpoints of
placed trees, and the mesh functions (``repro_torch.launch.mesh``) against
the JAX reference's on the CPU.

Tolerances: ``rescale_plan`` gives equal dicts and raises the same
exception types; ``reshard`` and a checkpoint of a placed tree are
bitwise (every shard the reference's shard for the device at that
position, and the global tree the original); the mesh functions' shapes
and axis names are the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JxMesh  # noqa: E402

from repro.distributed import sharding as jx_sh  # noqa: E402
from repro.ft import elastic as jx_el  # noqa: E402
from repro.models import params as jx_params  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.aqp import executor as pt_exec  # noqa: E402
from repro_torch.distributed import sharding as pt_sh  # noqa: E402
from repro_torch.ft import elastic as pt_el  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import mesh as pt_mesh  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.training import optimizer as pt_opt  # noqa: E402
from repro import configs as jx_configs  # noqa: E402

PLANS = [
    ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, 256),
    ({"data": 16, "model": 16}, {"data": 32, "model": 8}, 256),
    ({"data": 16, "model": 16}, {"data": 24, "model": 16}, 100),
    ({"data": 4, "model": 1}, {"data": 2, "model": 1}, 8),
    ({"data": 2, "model": 4}, {"data": 8}, 64),
    ({"pod": 2, "data": 2, "model": 2}, {"data": 3, "model": 2}, 12),
    ({"pod": 2, "data": 2, "model": 2}, {"pod": 4, "data": 1, "model": 2},
     6),
]


@pytest.mark.parametrize("old,new,batch", PLANS)
def test_rescale_plan_matches_the_reference(old, new, batch):
    try:
        want = jx_el.rescale_plan(old, new, batch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pt_el.rescale_plan(old, new, batch)
        assert str(got.value) == str(e)
        return
    assert pt_el.rescale_plan(old, new, batch) == want


def _meshes(forced_devices, data):
    jm = JxMesh(np.array(forced_devices(data)).reshape(data, 1),
                ("data", "model"))
    return jm, pt_exec.Mesh(("cpu",) * data, ("data", "model"), (data, 1))


def _tree(cfg, seed=0):
    """qwen-smoke's parameters and an AdamW state whose moments are
    random (bits to lose), as the port's tensors."""
    params = pt_params.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    state = pt_opt.adamw().init(params)
    state["step"].fill_(3)
    g = torch.Generator().manual_seed(seed + 1)
    for t in ([t for _, t in pt_params.tree_leaves(state["m"])]
              + [t for _, t in pt_params.tree_leaves(state["v"])]):
        t.copy_(torch.randn(t.shape, generator=g))
    return params, state


def _shardings(cfg, mesh, state_like):
    ps = pt_params.shardings(cfg, mesh, pt_sh.FSDP_RULES)
    return ps, pt_sh.opt_state_shardings("adamw", ps, state_like)


def _same(a, b):
    got = dict(pt_params.tree_leaves(a))
    for path, t in pt_params.tree_leaves(b):
        assert torch.equal(got[path], t), path


def test_reshard_through_a_checkpoint_is_bitwise(tmp_path, forced_devices):
    """Parameters and AdamW state placed under FSDP_RULES on (data 4,
    model 1), saved, restored and resharded onto (data 2, model 1): every
    shard the reference's ``reshard`` shard for the device at its
    position, and the global trees the originals."""
    arch = "qwen2.5-3b"
    cfg = pt_configs.get_smoke(arch)
    params, state = _tree(cfg)
    jm4, pm4 = _meshes(forced_devices, 4)
    jm2, pm2 = _meshes(forced_devices, 2)
    p4, s4 = _shardings(cfg, pm4, state)
    placed = pt_sh.device_put((params, state), (p4, s4))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, placed, {"mesh": pm4.shape})
    restored, extra = mgr.restore(placed)
    assert extra == {"mesh": {"data": 4, "model": 1}}
    for (_, a), (_, b) in zip(pt_params.tree_leaves(list(restored)),
                              pt_params.tree_leaves(list(placed))):
        assert a.sharding == b.sharding
        assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))
    p2, s2 = _shardings(cfg, pm2, state)
    moved = pt_el.reshard(restored, (p2, s2))
    got_p, got_s = pt_sh.device_get(moved)
    _same(got_p, params)
    _same(got_s["m"], state["m"])
    _same(got_s["v"], state["v"])
    assert torch.equal(got_s["step"], state["step"])
    # against the reference's reshard of the same host arrays
    jcfg = jx_configs.get_smoke(arch)
    host = pt_params.tree_map(lambda t: t.numpy(), params)
    want = jx_el.reshard(host, jx_params.shardings(jcfg, jm2,
                                                   jx_sh.FSDP_RULES))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    for path, t in pt_params.tree_leaves(moved[0]):
        by_dev = {s.device: np.asarray(s.data)
                  for s in flat[path].addressable_shards}
        for pos, dev in enumerate(jm2.devices.flat):
            np.testing.assert_array_equal(t.shards[pos].numpy(), by_dev[dev],
                                          err_msg=path)


def test_restore_places_by_the_shardings_given(tmp_path):
    """``restore(shardings=...)`` re-places onto another mesh; a plain
    tensor target comes back a tensor."""
    pm4 = pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (4, 1))
    pm2 = pt_exec.Mesh(("cpu",) * 2, ("data", "model"), (2, 1))
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    y = torch.arange(6, dtype=torch.bfloat16)
    tree = {"x": pt_sh.device_put(x, pt_sh.named(pm4, "data")), "y": y}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    got, _ = mgr.restore(tree, shardings={"x": pt_sh.named(pm2, None,
                                                           "data"),
                                          "y": None})
    assert got["x"].sharding.spec == (None, "data")
    assert [tuple(s.shape) for s in got["x"].shards] == [(8, 3), (8, 3)]
    assert torch.equal(pt_sh.device_get(got["x"]), x)
    assert isinstance(got["y"], torch.Tensor) and torch.equal(got["y"], y)


def test_reshard_of_tensors_and_sharded_tensors_alike():
    pm = pt_exec.Mesh(("cpu",) * 4, ("data", "model"), (2, 2))
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    s = pt_sh.named(pm, "model", "data")
    a = pt_el.reshard({"a": x}, {"a": s})["a"]
    b = pt_el.reshard({"a": pt_sh.device_put(x, pt_sh.named(pm))},
                      {"a": s})["a"]
    assert all(torch.equal(u, v) for u, v in zip(a.shards, b.shards))
    assert [tuple(t.shape) for t in a.shards] == [(2, 3)] * 4


def test_host_mesh_and_production_mesh_on_the_cpu():
    host = pt_mesh.make_host_mesh(device="cpu")
    assert host.axis_names == ("data",) and host.shape == {"data": 1}
    assert host.devices == (torch.device("cpu"),)
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="must be >= the product"):
            pt_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    # the reference refuses its too-few host devices the same way
    from repro.launch import mesh as jx_mesh

    if jax.device_count() < 256:
        with pytest.raises(ValueError, match="must be >= the product"):
            jx_mesh.make_production_mesh()


def test_meshes_want_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_mesh.make_production_mesh()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_over_enough_cards(multi_pod, monkeypatch):
    """With 600 visible devices (stand-ins for cards), the production mesh
    takes the first 256 or 512 as the reference's 16 x 16 or 2 x 16 x 16."""
    cards = [torch.device("cpu")] * 600
    monkeypatch.setattr(pt_mesh, "_visible", lambda device=None: cards)
    m = pt_mesh.make_production_mesh(multi_pod=multi_pod)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    assert m.shape == want and m.size == (512 if multi_pod else 256)
    assert pt_mesh.make_host_mesh().shape == {"data": 600}
