"""Collective-byte accounting of the port's programs, the reference's
``repro.launch.hlo_analysis``.

The reference parses XLA's HLO text after SPMD partitioning: each
collective op's result shape, per device, with while-loop bodies multiplied
by their trip count. Eager PyTorch has no HLO, and the port's placement is
one process's: a value crosses between mesh positions only where the port
calls ``distributed.sharding.report_collective``:
  - ``distributed.compression.ppermute``: ``collective-permute``, the
    payload one position receives, one op a tensor;
  - the compressed train step's mean of the pods' losses: ``all-reduce``
    of the 0-dim loss (the reference's ``pmean``);
  - ``models.ffn._moe_mesh``'s sum over the model axis: ``all-reduce`` of
    a position's (rows, d) partial, one a layer call (the reference's
    ``psum``);
  - ``ShardCtx.use_weights`` with ``gather_weights``: ``all-gather`` of
    each split weight, the gathered array.
``record_collectives()`` listens to them while it is active, and
``collective_bytes`` returns the reference's dict from what it heard.
Bytes are per device, as the reference counts them: those of the result
one position holds. A call inside a Python loop reports once a trip, the
port's counterpart of the reference's trip-count multiplication.
``device_put`` / ``device_get`` are host transfers, as in the reference,
and report nothing. The HLO parser itself (``parse_computations``,
``_loop_info``, ``_trip_count``, ``_call_edges``) has no counterpart.

Known difference: GSPMD inserts all-reduces for tensor-parallel dense
products; the port computes a dense layer on the mesh's first device and
has none of them, so on a TP-sharded dense step it counts fewer bytes than
XLA does.

Wire-cost factors: all-reduce 2x (RS+AG), others 1x (ring (n-1)/n ~ 1).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch.distributed import sharding as SH

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
WIRE_FACTOR = {"all-reduce": 2.0}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES[t.dtype]


@contextlib.contextmanager
def record_collectives():
    """Yield the list of ``(kind, bytes)`` of every crossing between mesh
    positions reported until the block ends, in order. Recording changes
    no value; with no recording active a crossing costs one loop over an
    empty list."""
    ops: List[Tuple[str, int]] = []

    def listen(kind, tree):
        if kind not in COLLECTIVES:
            raise ValueError(f"not a collective: {kind!r}")
        SH.tree_map(lambda t: ops.append((kind, tensor_bytes(t))), tree)

    SH.COLLECTIVE_LISTENERS.append(listen)
    try:
        yield ops
    finally:
        SH.COLLECTIVE_LISTENERS.remove(listen)


def collective_bytes(ops) -> Dict[str, object]:
    """Per-collective-kind bytes (per device) and wire bytes of a
    recording: the reference's dict."""
    out = defaultdict(float)
    op_counts = defaultdict(int)
    for kind, n in ops:
        out[kind] += n
        op_counts[kind] += 1
    out_wire = {k: v * WIRE_FACTOR.get(k, 1.0) for k, v in out.items()}
    return {
        "bytes_by_kind": dict(out),
        "wire_bytes_by_kind": out_wire,
        "wire_bytes_total": float(sum(out_wire.values())),
        "op_counts": dict(op_counts),
    }
