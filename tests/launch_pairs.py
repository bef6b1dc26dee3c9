"""Shared by the launch-layer tests (``test_torch_launch*.py``): the
reference's and the port's cells over the same 8-position meshes, tree
paths, and the leaf-by-leaf comparison of abstract values.

The reference's meshes are the conftest's forced host devices, (data 2,
model 4) and (pod 2, data 2, model 2); the port's list ``"cpu"`` as many
times with the same axes.
"""
import functools

import jax
import numpy as np
from jax.sharding import Mesh as JxMesh

from repro.launch import cells as jx_cells
from repro_torch.aqp import executor as pt_exec
from repro_torch.launch import cells as pt_cells

CELLS = jx_cells.cell_list()
MESHES = {False: ((2, 4), ("data", "model")),
          True: ((2, 2, 2), ("pod", "data", "model"))}
# A probe evaluated on meta in test_torch_launch.py costs well under a
# second; the others (a whole model's vjp, the SSM archs' chunk loops over
# a sequence, the MoE layers' loops over every mesh position) are held in
# test_torch_launch_probes.py and test_torch_launch_ssm_probes.py, or, for
# the SSM archs' whole-model vjp (minutes on meta: 32 layers x 256 chunk
# steps, ~13 ms each), nowhere.
SSM_ARCHS = {"rwkv6-3b", "hymba-1.5b"}
MOE_ARCHS = {"arctic-480b", "llama4-maverick-400b-a17b"}


def slow_on_meta(arch, shape, label):
    """Whether a probe's evaluation on meta costs a second or more."""
    if label == "microbatch_vjp":
        return True
    if arch in SSM_ARCHS:
        return shape != "decode_32k" and shape != "long_500k" \
            and not label.startswith("ssm_chunk")
    return arch in MOE_ARCHS


@functools.lru_cache(maxsize=None)
def jx_mesh(multi_pod):
    shape, axes = MESHES[multi_pod]
    return JxMesh(np.array(jax.devices()[:int(np.prod(shape))])
                  .reshape(shape), axes)


@functools.lru_cache(maxsize=None)
def pt_mesh(multi_pod):
    shape, axes = MESHES[multi_pod]
    return pt_exec.Mesh(("cpu",) * int(np.prod(shape)), axes, shape)


@functools.lru_cache(maxsize=None)
def meta_mesh(multi_pod):
    """``pt_mesh``'s axes over the ``meta`` device: a cell built on it runs
    its steps and probes on meta tensors."""
    shape, axes = MESHES[multi_pod]
    return pt_exec.Mesh(("meta",) * int(np.prod(shape)), axes, shape)


@functools.lru_cache(maxsize=None)
def cells_pair(arch, shape, multi_pod):
    """(the reference's cell, the port's) over the 8-device meshes."""
    return (jx_cells.build_cell(arch, shape, jx_mesh(multi_pod), multi_pod),
            pt_cells.build_cell(arch, shape, pt_mesh(multi_pod), multi_pod))


def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def jx_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(key(k) for k in path): leaf for path, leaf in flat}


def pt_paths(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}.{i}" if prefix else str(i))
        else:
            out[prefix] = t

    walk(tree, "")
    return out


def dtype_name(dt):
    return str(dt).split(".")[-1]


def hold_leaves(got, want, what, specs=True):
    """Leaf by leaf: the same paths, shapes, dtypes (and specs)."""
    got, want = pt_paths(got), jx_paths(want)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:6])
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == tuple(w.shape), (what, path, g.shape,
                                                  w.shape)
        assert dtype_name(g.dtype) == dtype_name(w.dtype), (
            what, path, g.dtype, w.dtype)
        if specs:
            assert tuple(g.sharding.spec) == tuple(w.sharding.spec), (
                what, path, g.sharding.spec, w.sharding.spec)


def probe_outputs_match(arch, shape, labels):
    """The port's probes on meta (its cell built over ``meta_mesh``)
    against ``jax.eval_shape`` of the reference's (single pod)."""
    want = cells_pair(arch, shape, False)[0]
    got = pt_cells.build_cell(arch, shape, meta_mesh(False), False)
    by_label = {p[0]: p for p in want.probes}
    done = []
    for label, _, fn, args in got.probes:
        if label not in labels:
            continue
        _, _, jfn, jargs = by_label[label]
        out = fn(*pt_cells.call_args(args))
        hold_leaves(pt_cells.abstract(out), jax.eval_shape(jfn, *jargs),
                    f"{arch} {shape} {label}", specs=False)
        done.append(label)
    assert sorted(done) == sorted(labels)
