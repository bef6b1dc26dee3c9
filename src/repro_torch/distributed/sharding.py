"""Logical-axis -> mesh-axis rules, sharding trees for steps and caches, and
the placement types they are made of.

Baseline layout (Megatron-style TP x DP, + pod axis for multi-pod DP):
  batch        -> ('pod', 'data')
  vocab/heads/ffn/experts -> 'model'
  embed (d_model dims), head_dim, states -> replicated
KV heads shard over 'model' only when divisible (else replicated — standard
GQA practice); head counts are padded at spec-build time (ArchConfig).
Alternative rule sets (fsdp / sequence-parallel) are the reference's
``repro.distributed.sharding``, name for name.

The reference builds these trees from ``jax.sharding``; the port's
counterparts live here, over ``repro_torch.aqp.executor.Mesh``:
  - ``PartitionSpec``: one entry per array dim — ``None`` (replicated), a
    mesh axis name, or a tuple of names (sharded over their product, the
    first name major);
  - ``NamedSharding``: a frozen ``(mesh, spec)``; ``devices_indices_map``
    gives each mesh position (row-major, as ``mesh.devices`` lists them)
    the index of the global array it holds, slice for slice what JAX's
    gives the device at that position;
  - ``ShapeDtypeStruct``: shape, dtype and an optional sharding;
  - ``device_put(x, sharding)``: a ``ShardedTensor``, one local tensor per
    mesh position on that position's device, each with storage of its own
    (a mesh lists one card several times, and the port's optimizers and
    caches write in place: a shared buffer would take their writes once
    per replica); ``device_get`` assembles the global tensor.
The placement is one process's (the reference's is single-controller
too): no collective runs, a shard moves with ``Tensor.to``. The places
where a value crosses between mesh positions call ``report_collective``
with the collective XLA runs there, which
``repro_torch.launch.hlo_analysis.record_collectives`` counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.aqp.executor import Mesh

DEFAULT_RULES = {
    "vocab": "model",
    "heads": "model",
    "ffn": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
}

# ZeRO/FSDP-flavoured: additionally shard the d_model dimension of weights
# over the data axis (parameter+optimizer state sharding; gathered per layer).
FSDP_RULES = dict(DEFAULT_RULES, embed="data")

# Pure ZeRO-3 data parallelism: the whole mesh is one data-parallel domain
# (batch over ('data', 'model')); weights and optimizer state fully sharded
# on their d_model dim and gathered per layer. Dense archs only (MoE expert
# parallelism needs the model axis).
PURE_DP_RULES = {
    "vocab": None,
    "heads": None,
    "ffn": None,
    "experts": None,
    "embed": ("data", "model"),
    "layers": None,
    "_batch_axes": ("data", "model"),  # consumed by launch.cells
}


def _canonical(part):
    """A spec entry as JAX keeps it: an empty tuple is ``None``, a tuple
    of one name that name."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: ``PartitionSpec("data", None)``;
    entries canonical as JAX makes them (``("data",)`` is ``"data"``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """``jax.ShapeDtypeStruct``: an array's shape, dtype and sharding."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional["NamedSharding"] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: an array laid out over ``mesh`` by
    ``spec``."""

    mesh: Mesh
    spec: PartitionSpec = PartitionSpec()

    def __post_init__(self):
        spec = PartitionSpec(*self.spec)
        used = [a for axes in self._axes(spec) for a in axes]
        for a in used:
            if a not in self.mesh.axis_names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {self.mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        object.__setattr__(self, "spec", spec)

    @staticmethod
    def _axes(spec) -> Tuple[Tuple[str, ...], ...]:
        return tuple(() if e is None else (e,) if isinstance(e, str)
                     else tuple(e) for e in spec)

    def shard_counts(self, ndim: int) -> Tuple[int, ...]:
        """How many ways each of ``ndim`` dims is split."""
        axes = self._axes(self.spec)
        if len(axes) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dims")
        shape = self.mesh.shape
        return tuple(math.prod(shape[a] for a in axes[d])
                     if d < len(axes) else 1 for d in range(ndim))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        counts = self.shard_counts(len(global_shape))
        for n, k in zip(global_shape, counts):
            if n % k:
                raise ValueError(
                    f"sharding {self.spec} over {self.mesh.shape} splits a "
                    f"dim of {n} {k} ways (shape {tuple(global_shape)})")
        return tuple(n // k for n, k in zip(global_shape, counts))

    def devices_indices_map(self, global_shape) -> Dict[int, Tuple[slice, ...]]:
        """``{mesh position: index tuple}``: the part of a ``global_shape``
        array each position holds (``slice(None)`` on a dim not split)."""
        local = self.shard_shape(global_shape)
        counts = self.shard_counts(len(global_shape))
        axes = self._axes(self.spec)
        shape = self.mesh.shape
        out = {}
        for pos in range(self.mesh.size):
            coords = self.mesh.coords(pos)
            idx = []
            for d, n in enumerate(local):
                if counts[d] == 1:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in axes[d]:
                    k = k * shape[a] + coords[a]
                idx.append(slice(k * n, (k + 1) * n))
            out[pos] = tuple(idx)
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global array as placed by ``device_put``: ``shards[p]`` is the
    part of it that mesh position ``p`` holds, on ``mesh.devices[p]``."""

    shards: Tuple[torch.Tensor, ...]
    sharding: NamedSharding
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def unbind(self, dim: int = 0):
        """One ``ShardedTensor`` per index of dim 0, which must not be
        split (a stacked layer group's layers)."""
        if dim != 0 or self.sharding.shard_counts(self.ndim)[0] != 1:
            raise ValueError(f"unbind takes an unsplit dim 0, not dim {dim} "
                             f"of {self.sharding.spec}")
        sharding = NamedSharding(self.sharding.mesh,
                                 PartitionSpec(*self.sharding.spec[1:]))
        parts = [s.unbind(0) for s in self.shards]
        return tuple(ShardedTensor(tuple(p[i] for p in parts), sharding,
                                   self.shape[1:], self.dtype)
                     for i in range(self.shape[0]))


# The listeners ``report_collective`` tells; empty unless a recording is on.
COLLECTIVE_LISTENERS = []


def report_collective(kind: str, tree):
    """Tell each listener that the tensors of ``tree`` crossed between mesh
    positions as one ``kind`` collective (an HLO op name) apiece, each as
    large as what one position holds after it. A logical crossing is
    reported even where both positions are one card."""
    for listener in COLLECTIVE_LISTENERS:
        listener(kind, tree)


def _is_tree(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and tuples, with
    the matching leaves of ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def device_put(x, sharding):
    """``x`` (a tensor, an array or a ``ShardedTensor``; or a tree of them)
    placed by ``sharding`` (one ``NamedSharding``, or a tree of them
    matching ``x``): ``ShardedTensor``s whose shards own their storage."""
    if _is_tree(x):
        if isinstance(sharding, NamedSharding):
            return tree_map(lambda a: device_put(a, sharding), x)
        return tree_map(device_put, x, sharding)
    if isinstance(x, ShardedTensor):
        x = device_get(x, x.shards[0].device)
    x = torch.as_tensor(x)
    shards = tuple(
        x[idx].to(device=sharding.mesh.devices[pos], copy=True,
                  memory_format=torch.contiguous_format)
        for pos, idx in sharding.devices_indices_map(x.shape).items())
    return ShardedTensor(shards, sharding, tuple(x.shape), x.dtype)


def device_get(x, device="cpu"):
    """The global tensor of a ``ShardedTensor`` (or a tree of them) on
    ``device`` (the host by default, as ``jax.device_get``); a tensor is
    moved there, any other leaf returned as it is."""
    if _is_tree(x):
        return tree_map(lambda a: device_get(a, device), x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if not isinstance(x, ShardedTensor):
        return x
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    seen = set()
    for pos, idx in x.sharding.devices_indices_map(x.shape).items():
        key = tuple((s.start, s.stop) for s in idx)
        if key not in seen:  # the first of a shard's replicas
            seen.add(key)
            out[idx] = x.shards[pos].to(device)
    return out


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def data_shards(mesh: Mesh, multi_pod: bool) -> int:
    n = mesh.shape["data"]
    return n * (mesh.shape["pod"] if multi_pod else 1)


def named(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def batch_sharding(mesh: Mesh, multi_pod: bool, ndim: int,
                   batch_dim: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[batch_dim] = batch_axes(multi_pod)
    return named(mesh, *spec)


def _is_state_leaf(x) -> bool:
    return isinstance(x, dict) and ("vr" in x or "v" in x)


def _map_state(fn, tree, *rest):
    """``fn`` over Adafactor's per-parameter state dicts (``{vr, vc}`` or
    ``{v}``) of ``tree``, with the matching leaves of ``rest``."""
    if _is_state_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_state(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_state(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _first_leaf(tree):
    while _is_tree(tree):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def opt_state_shardings(opt_name: str, param_shardings, abstract_state):
    """Optimizer-state sharding mirroring parameter shardings.

    adamw: m/v identical to params. adafactor: vr drops the last dim's spec,
    vc drops the second-to-last.
    """
    mesh = _first_leaf(param_shardings).mesh

    if opt_name == "adamw":
        return {
            "m": param_shardings,
            "v": param_shardings,
            "step": named(mesh),
        }

    # adafactor: walk the param sharding tree and emit {vr, vc} or {v}.
    def state_for(shard, aparam):
        ndim = len(aparam.shape)
        spec = list(shard.spec)
        spec = spec + [None] * (ndim - len(spec))
        if ndim >= 2:
            return {
                "vr": named(mesh, *spec[:-1]),
                "vc": named(mesh, *(spec[:-2] + spec[-1:])),
            }
        return {"v": named(mesh, *spec)}

    return {
        "v": tree_map(state_for, param_shardings,
                  abstract_state_params(abstract_state)),
        "step": named(mesh),
    }


def abstract_state_params(abstract_state):
    """adafactor state['v'] mirrors params structure with {vr,vc}|{v} leaves;
    recover per-param shapes from vr/vc for spec derivation."""

    def leaf(x):
        if _is_state_leaf(x):
            if "v" in x:
                return ShapeDtypeStruct(x["v"].shape, x["v"].dtype)
            vr, vc = x["vr"], x["vc"]
            return ShapeDtypeStruct(tuple(vr.shape) + tuple(vc.shape[-1:]),
                                    vr.dtype)
        return x

    return _map_state(leaf, abstract_state["v"])


def cache_shardings(mesh: Mesh, multi_pod: bool, abstract_caches, cfg, *,
                    seq_axis=None, batch_sharded: bool = True):
    """Sharding tree for decode caches.

    Convention (see transformer.init_cache): leaves are either
      attention k/v:  (R?, B, S, KV, hd)
      slot_pos:       (R?, S)
      cross xk/xv:    (R?, B, N, KV, hd)
      rwkv state:     (R?, B, H, k, v) / x_prev (R?, B, d)
      mamba conv/h:   (R?, B, K, di) / (R?, B, di, n)
    Batch shards over the data axes; KV heads over 'model' when divisible;
    mamba channel dims over 'model'. ``seq_axis`` shards the KV sequence
    dim: over 'data' for long-context (batch=1) cells, over 'model'
    (flash-decoding style, batch stays data-sharded) for decode.
    """
    b_ax = batch_axes(multi_pod) if batch_sharded else None
    kv_ax = "model" if (cfg.kv_sharded and seq_axis != "model") else None

    # Match by leaf name (the last dict key; a list index names nothing);
    # any extra leading dims are the stacking dims of repeated layer
    # groups (replicated).
    def spec_for(x, name):
        base = {
            "k": (b_ax, seq_axis, kv_ax, None),
            "v": (b_ax, seq_axis, kv_ax, None),
            "xk": (b_ax, None, kv_ax, None),
            "xv": (b_ax, None, kv_ax, None),
            "slot_pos": (None,),
            "x_prev": (b_ax, None),
            "state": (b_ax, None, None, None),
            "conv": (b_ax, None, "model"),
            "h": (b_ax, "model", None),
        }.get(name)
        if base is None:
            base = (b_ax,) + (None,) * (x.ndim - 1)
        extra = x.ndim - len(base)
        return named(mesh, *((None,) * extra + tuple(base)))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, "") for v in tree)
        return spec_for(tree, name)

    return walk(abstract_caches, "")
