"""Elastic re-scale: resume a run on a different mesh (the reference's
``repro.ft.elastic``).

Checkpoints store host (global) arrays; restoring with the *new* mesh's
sharding tree re-lays the state out — no format migration. The pieces:

  - ``reshard(tree, shardings)``: each leaf's global tensor placed by the
    new ``NamedSharding`` (``distributed.sharding.device_put``).
  - ``rescale_plan(old_shape, new_shape)``: validates that the model axis is
    unchanged (TP degree is baked into padded head counts) and that the
    global batch stays divisible; data-parallel size may grow/shrink freely
    (the data pipeline re-slices by new process/topology, see
    repro_torch.data).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.distributed.sharding import device_get, device_put, tree_map


def reshard(tree, shardings):
    return tree_map(lambda x, s: device_put(device_get(x), s), tree,
                    shardings)


def rescale_plan(old_mesh_shape: Dict[str, int], new_mesh_shape: Dict[str, int],
                 global_batch: int) -> Dict:
    if old_mesh_shape.get("model") != new_mesh_shape.get("model"):
        raise ValueError(
            "elastic rescale keeps the model axis fixed "
            f"({old_mesh_shape.get('model')} -> {new_mesh_shape.get('model')}): "
            "head/vocab padding is TP-degree dependent")
    new_dp = new_mesh_shape.get("data", 1) * new_mesh_shape.get("pod", 1)
    if global_batch % new_dp:
        raise ValueError(f"global batch {global_batch} not divisible by new "
                         f"data parallelism {new_dp}")
    return {
        "new_data_parallel": new_dp,
        "per_replica_batch": global_batch // new_dp,
    }
