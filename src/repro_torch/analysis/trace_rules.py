"""The trace layer: rules over the recorded runs of the scan plane's
programs (``repro_torch.analysis.programs``).

Each rule states one clause of the scan plane's parity or performance
contract over what a program ran, aten op by aten op, instead of hoping a
parity test trips it. The reference reads jaxprs and StableHLO; eager
PyTorch has neither, so each rule has an eager design of its own:

T001  canonical fold shape. A product over the tuple axis is an ``mm`` (or
      ``addmm``) of two 2-D operands whose left operand is the
      transpose of a tuple-major tensor (``X.T @ Y`` contracts the leading
      axis of both, the reference's fold ``dot_general``). Every such
      product is (128, 512) x (512, P): SCAN_TILE_Q x SCAN_TILE_T tiles. A
      variable-shape product is the untiled fold's bug (the contraction
      order changes with Q padding; a one-ulp parity flake). On the card the fused
      programs fold inside K1 or K4, which no trace sees: a launch of a
      fold kernel there stands for the fold, noted as ``info`` (its order is
      held bitwise against the plain fold on the card).
T002  ascending left fold. Per snippet tile, the tile products accumulate
      as a chain ``acc + part_i`` whose tuple tile ``i`` (the row the
      product's tuple-major operand starts at, from its storage offset)
      rises strictly; never a tree, never descending.
T003  shard-local mask build. The rows ``executor.place_shards`` hands a
      shard carry that shard's label, and labels follow the dataflow. A
      concatenation, a view or a copy (onto the home device) is a gather
      and keeps each row's label; a pointwise op or a reduction over other
      dims keeps aligned rows' labels. Any other op whose result depends on
      the rows of two or more shards is one cross-shard op, the eager
      counterpart of a collective, and its result belongs to no shard. A
      ``mask-build`` program has none.
T004  bounded cross-shard ops: an ``agg`` program has at most
      ``PSUM_BOUND``. A program with no shard labels has none, as a
      single-device program has no collective in the reference.
T005  no (T, Q) buffer on the fused path: no tensor the program creates
      has two dims at least (T, Q) in either order, and on the card the
      peak of allocated memory over the run, above its start, stays below
      T * Q * 8 bytes. On the CPU a kernel wrapper runs its plain version,
      which builds the mask by design: there the rule gives one ``info``
      and gates nothing; it gates on the card.
T006  float64 policy: on a ``partials-f64`` program no float64 to float32
      conversion (``_to_copy``, ``copy_``), no op making float32 from
      float64 inputs, and no floating program output other than float64.
T007  launch-signature cardinality. The (Q, fill) improve ladder is driven
      through a real ``Synopsis.improve`` (Q padded by ``bucket_size`` and
      ``pad_snippets``, the state by ``_padded_state``) and the calls that
      reach ``gp_batch_infer`` are read: their argument shapes and dtypes
      and the launch plan (the built library's ``gp_plan`` on the card, its
      mirror ``gp_plan`` on the CPU). There must be exactly one signature
      per (Q-bucket, fill-bucket) pair: more means an unpadded size leaked
      into the kernel's launch. The scan leg reads the calls that reach
      K1's wrapper (``fused_masked_scan``; on the card with the library's
      ``fused_scan_plan`` per measure group): the same shape twice is one
      signature, a new shape a second. In eager PyTorch nothing is compiled
      per shape, so this pins that a launch is a function of shapes alone.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.findings import ERROR, INFO, Finding
from repro_torch.analysis.programs import (FOLD_KERNELS, PSUM_BOUND, CallTap,
                                           OpRecord, Program, TensorInfo,
                                           engine_programs)
from repro_torch.core.types import resolve_device

F64, F32 = torch.float64, torch.float32

# ------------------------------------------------------------- fold products

# ``@`` and ``matmul`` reach the dispatcher as these (or as ``bmm`` and
# ``dot``, which are not 2-D products); ``.T`` as ``permute``.
PRODUCT_OPS = {"aten.mm.default": (0, 1), "aten.addmm.default": (1, 2)}
TRANSPOSE_OPS = ("aten.t.default", "aten.transpose.int", "aten.permute.default")


def _is_transpose(rec: Optional[OpRecord]) -> bool:
    if rec is None or rec.op not in TRANSPOSE_OPS:
        return False
    src = rec.args[0]
    if rec.op == "aten.permute.default":
        return len(src.shape) == 2 and tuple(rec.args[1]) == (1, 0)
    return len(src.shape) == 2


def fold_products(trace):
    """``(record, lhs, rhs)`` of every product over the tuple axis: 2-D x
    2-D, the left operand the transpose of a tuple-major tensor."""
    produced: Dict[int, OpRecord] = {}
    for rec in trace.records:
        if rec.op in PRODUCT_OPS:
            i, j = PRODUCT_OPS[rec.op]
            lhs, rhs = rec.args[i], rec.args[j]
            if (len(lhs.shape) == 2 and len(rhs.shape) == 2
                    and _is_transpose(produced.get(lhs.uid))):
                yield rec, lhs, rhs
        for o in rec.outputs:
            produced[o.uid] = rec


def _tuple_row(rhs: TensorInfo) -> int:
    """The tuple row a tuple-major operand starts at (its storage offset
    over its row stride)."""
    return rhs.offset // rhs.stride[0] if rhs.stride[0] else 0


# ----------------------------------------------------------------- T001/T002


def check_fold_dot_shapes(program: Program, tile_t: Optional[int] = None,
                          tile_q: Optional[int] = None) -> List[Finding]:
    """T001: every fold product is exactly (tile_q, tile_t) x (tile_t, P)."""
    from repro_torch.kernels import SCAN_TILE_Q, SCAN_TILE_T

    tile_t = SCAN_TILE_T if tile_t is None else tile_t
    tile_q = SCAN_TILE_Q if tile_q is None else tile_q
    where = f"program:{program.name}"
    trace = program.trace()
    out: List[Finding] = []
    n_fold = 0
    for rec, lhs, rhs in fold_products(trace):
        n_fold += 1
        major = (lhs.shape[1], lhs.shape[0])  # the tuple-major operand
        if major != (tile_t, tile_q) or rhs.shape[0] != tile_t:
            out.append(Finding(
                "T001", ERROR, where,
                f"tuple-axis fold product has shape {major} x {rhs.shape} "
                f"({rec.op}); the canonical fold requires ({tile_t}, "
                f"{tile_q}) x ({tile_t}, P) for every product",
                "route the reduction through repro_torch.aqp.executor."
                "masked_tile_fold (fixed SCAN_TILE_T x SCAN_TILE_Q tiles); a "
                "variable-shape product changes the contraction order and "
                "breaks Q-pad/block-size bitwise invariance (the untiled "
                "fold's 1-ulp bug)",
            ))
    if n_fold:
        return out
    kernels = {k: n for k, n in trace.launches.items() if k in FOLD_KERNELS}
    if kernels:
        what = ", ".join(f"{k} x{n}" for k, n in sorted(kernels.items()))
        return [Finding(
            "T001", INFO, where,
            f"the fold ran inside a kernel ({what}), which no trace sees; "
            "its fixed order is held bitwise against the plain fold on the "
            "card (chip_smoke.py phase 2)", "",
        )]
    return [Finding(
        "T001", ERROR, where,
        "no tuple-axis fold dot found: the program no longer performs the "
        "canonical masked_tile_fold reduction",
        "aggregate mask x payload through masked_tile_fold so all scan "
        "paths share one bitwise reduction order",
    )]


ADD_OPS = ("aten.add.Tensor", "aten.add_.Tensor")


def check_fold_order(program: Program) -> List[Finding]:
    """T002: fold partials accumulate as an ascending left fold."""
    where = f"program:{program.name}"
    trace = program.trace()
    out: List[Finding] = []
    # uid -> (lowest tuple row, highest tuple row, a single product)
    info = {rec.outputs[0].uid: (_tuple_row(rhs),) * 2 + (True,)
            for rec, _, rhs in fold_products(trace)}
    for rec in trace.records:
        if rec.op not in ADD_OPS or len(rec.inputs) != 2:
            continue
        a, b = rec.inputs
        ia, ib = info.get(a.uid), info.get(b.uid)
        if ia is None or ib is None:
            continue
        if not ib[2]:
            out.append(Finding(
                "T002", ERROR, where,
                "fold add combines two accumulated subtrees: a tree "
                "reduction, not the canonical left fold",
                "accumulate per-tile products strictly left to right (acc = "
                "acc + part), as masked_tile_fold does",
            ))
        elif ia[1] >= ib[0]:
            out.append(Finding(
                "T002", ERROR, where,
                f"fold accumulates tuple tile t={ib[0]} after tile t={ia[1]}: "
                "not an ascending left fold",
                "fold tuple tiles in ascending start order; fp addition is "
                "not associative, so any other order breaks bitwise parity "
                "with the oracle",
            ))
        info[rec.outputs[0].uid] = (min(ia[0], ib[0]), max(ia[1], ib[1]),
                                    False)
    return out


# ------------------------------------------------------- T003/T004 shards


@dataclasses.dataclass(frozen=True)
class _Rows:
    """The shard labels of one tensor: the shards it depends on and, where
    followed, its dim-0 rows as ``((start, stop, shards), ...)``."""

    shards: frozenset
    segs: Optional[tuple] = None

    def __post_init__(self):
        if self.segs is not None:  # the shards of the rows it holds
            object.__setattr__(self, "shards", frozenset().union(
                *(s for _, _, s in self.segs)))

    def rows(self, n: int) -> Optional[tuple]:
        if self.segs is None and len(self.shards) == 1:
            return ((0, n, self.shards),)
        return self.segs


def _rows_of(info: TensorInfo, label: Optional[_Rows]) -> Optional[tuple]:
    n = info.shape[0] if info.shape else 1
    if label is None:
        return ((0, n, frozenset()),)
    return label.rows(n)


def _cut(segs, start, stop):
    out = []
    for a, b, s in segs:
        lo, hi = max(a, start), min(b, stop)
        if lo < hi:
            out.append((lo - start, hi - start, s))
    return tuple(out)


def _dim(rec: OpRecord, pos: int, default: int, ndim: int) -> int:
    d = rec.args[pos] if len(rec.args) > pos else rec.kwargs.get("dim",
                                                                  default)
    return d + ndim if d < 0 else d


GATHER_OPS = ("aten.cat.default", "aten.stack.default")
COPY_OPS = ("aten.clone.default", "aten._to_copy.default", "aten.copy_.default",
            "aten.detach.default", "aten.alias.default",
            "aten.lift_fresh.default", "aten.expand.default",
            "aten.view.default", "aten._unsafe_view.default")
DIM_VIEWS = ("aten.slice.Tensor", "aten.select.int", "aten.unsqueeze.default",
             "aten.squeeze.dim")
ROW_REDUCTIONS = ("aten.sum.dim_IntList", "aten.all.dim", "aten.any.dim",
                  "aten.amax.default", "aten.amin.default",
                  "aten.mean.dim", "aten.prod.dim_int")


def _gather(rec: OpRecord, labels, shards) -> _Rows:
    tensors = rec.args[0]
    ndim = len(tensors[0].shape)
    stack = rec.op == "aten.stack.default"
    if _dim(rec, 1, 0, ndim + stack) != 0:
        rows = {_rows_of(t, labels.get(t.uid)) for t in tensors
                if t.uid in labels}
        return _Rows(shards, rows.pop() if len(rows) == 1 else None)
    segs, at = [], 0
    for t in tensors:
        lab = labels.get(t.uid)
        if stack:
            segs.append((at, at + 1, lab.shards if lab else frozenset()))
            at += 1
            continue
        rows = _rows_of(t, lab)
        if rows is None:
            return _Rows(shards)
        segs.extend((a + at, b + at, s) for a, b, s in rows)
        at += t.shape[0]
    return _Rows(shards, tuple(segs))


def _same_rows(rec: OpRecord, src: TensorInfo, label: _Rows,
               shards) -> _Rows:
    """A view or copy of one labelled tensor."""
    out = rec.outputs[0]
    rows = _rows_of(src, label)
    if rec.op in DIM_VIEWS:
        d = _dim(rec, 1, 0, len(src.shape) + (rec.op ==
                                              "aten.unsqueeze.default"))
        if d != 0:
            return _Rows(shards, rows)
        if rec.op == "aten.slice.Tensor" and rows is not None:
            start = rec.args[2] if len(rec.args) > 2 else 0
            stop = rec.args[3] if len(rec.args) > 3 else src.shape[0]
            step = rec.args[4] if len(rec.args) > 4 else 1
            n = src.shape[0]
            start = 0 if start is None else min(max(start + n * (start < 0),
                                                    0), n)
            stop = n if stop is None else min(max(stop + n * (stop < 0), 0),
                                              n)
            if step == 1:
                return _Rows(shards, _cut(rows, start, stop))
        if rec.op == "aten.select.int" and rows is not None:
            i = rec.args[2] + src.shape[0] * (rec.args[2] < 0)
            (_, _, s), = _cut(rows, i, i + 1)
            return _Rows(s) if s else None
        return _Rows(shards)
    if rec.op in COPY_OPS and out.shape[:1] == src.shape[:1]:
        return _Rows(shards, rows)
    return _Rows(shards)


def _row_local(rec: OpRecord, labelled, labels, shards) -> Optional[_Rows]:
    """A pointwise op or a reduction over dims other than 0 whose labelled
    inputs share their rows, dim 0 aligned with the output's."""
    out = rec.outputs[0] if rec.outputs else None
    if out is None or not out.shape:
        return None
    if rec.op in ROW_REDUCTIONS:
        src = rec.args[0]
        dims = rec.args[1] if len(rec.args) > 1 else None
        dims = (dims,) if isinstance(dims, int) else dims
        if not dims or any((d + len(src.shape)) % len(src.shape) == 0
                           for d in dims):
            return None
    elif not rec.pointwise:
        return None
    rows = {_rows_of(t, labels[t.uid]) for t in labelled}
    reduce = rec.op in ROW_REDUCTIONS
    if (len(rows) != 1 or None in rows
            or any(t.shape[:1] != out.shape[:1]
                   or (not reduce and len(t.shape) != len(out.shape))
                   for t in labelled)):
        return None
    return _Rows(shards, rows.pop())


def cross_shard_ops(trace) -> List[tuple]:
    """``(record, shards)`` of every op whose result depends on the rows of
    two or more shards, other than a gather, a view or a copy."""
    # A shard's slices keep their label from the op that makes them on.
    seeds = {u: _Rows(frozenset({s})) for u, s in trace.shards.items()}
    labels: Dict[int, _Rows] = dict(seeds)
    found = []
    for rec in trace.records:
        ins = rec.inputs
        if rec.op == "aten.copy_.default":  # the target takes the source's
            ins = [rec.args[1]]
        labelled = [t for t in ins if t.uid in labels]
        shards = frozenset().union(*(labels[t.uid].shards for t in labelled))
        if not shards:
            label = None
        elif len(shards) == 1:
            label = _Rows(shards)
        elif rec.op in GATHER_OPS:
            label = _gather(rec, labels, shards)
        elif (rec.view or rec.op in COPY_OPS) and len(labelled) == 1:
            label = _same_rows(rec, labelled[0], labels[labelled[0].uid],
                               shards)
        else:
            label = _row_local(rec, labelled, labels, shards)
            if label is None:
                found.append((rec, shards))
        for o in rec.outputs:
            if o.uid in seeds:
                labels[o.uid] = seeds[o.uid]
            elif label is None:
                labels.pop(o.uid, None)
            else:
                labels[o.uid] = label
    return found


def _detail(ops) -> str:
    counts = collections.Counter(rec.op for rec, _ in ops)
    return ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))


def check_mask_build_collectives(program: Program) -> List[Finding]:
    """T003: the sharded mask build has no cross-shard op."""
    ops = cross_shard_ops(program.trace())
    if not ops:
        return []
    return [Finding(
        "T003", ERROR, f"program:{program.name}",
        f"sharded mask build has {len(ops)} cross-shard op(s) "
        f"({_detail(ops)}); the mask-build stage must be embarrassingly "
        "parallel over the tuple axis",
        "keep each shard to its own predicate compares and gather the masks "
        "onto the home device; reduce there, in the plain fold's order, "
        "instead of across shards",
    )]


def check_agg_collectives(program: Program,
                          bound: int = PSUM_BOUND) -> List[Finding]:
    """T004: an aggregation program has a bounded cross-shard op count."""
    ops = cross_shard_ops(program.trace())
    if len(ops) <= bound:
        return []
    return [Finding(
        "T004", ERROR, f"program:{program.name}",
        f"aggregation program has {len(ops)} cross-shard op(s) "
        f"({_detail(ops)}), above the bound of {bound}",
        "a per-shard reduction tree rounds differently than the oracle "
        "fold; reduce on one device in canonical tile order",
    )]


# ---------------------------------------------------------------- T005


def _covers(shape, t: int, q: int) -> bool:
    return any(a >= t and b >= q
               for a, b in itertools.permutations(shape, 2))


def check_no_tq_buffer(program: Program) -> List[Finding]:
    """T005: no (T, Q) tensor on the fused path, and on the card a peak
    of allocated memory below T * Q * 8 bytes."""
    t, q = program.t, program.q
    where = f"program:{program.name}"
    trace = program.trace()
    bad = sorted({o.shape for rec in trace.records for o in rec.outputs
                  if _covers(o.shape, t, q)})
    shapes = ", ".join(str(s) for s in bad)
    if bad and program.plain_stand_in:
        return [Finding(
            "T005", INFO, where,
            f"on the CPU the wrapper runs its kernel's plain version, which "
            f"builds the ({t}, {q}) mask by design ({shapes}); the rule "
            "gates on the card (chip_smoke.py phase 12)", "",
        )]
    out: List[Finding] = []
    hint = ("the mask must live tile by tile inside the kernel (the fused "
            "scan never writes it to memory); a full-mask intermediate "
            "un-fuses the scan")
    if bad:
        out.append(Finding(
            "T005", ERROR, where,
            f"fused-kernel path creates tensor(s) of shape {shapes}: at "
            f"least the full ({t}, {q}) predicate mask", hint))
    limit = t * q * 8
    if trace.peak_bytes is not None and trace.peak_bytes >= limit:
        out.append(Finding(
            "T005", ERROR, where,
            f"fused-kernel path's peak device memory is {trace.peak_bytes} "
            f"bytes above its start, at least T * Q * 8 = {limit} bytes",
            hint))
    return out


# ---------------------------------------------------------------- T006

CONVERT_OPS = {"aten._to_copy.default": (0, None),
               "aten.copy_.default": (1, 0)}


def check_partials_f64(program: Program) -> List[Finding]:
    """T006: float64 end to end on every path feeding Partials."""
    where = f"program:{program.name}"
    trace = program.trace()
    out: List[Finding] = []
    for rec in trace.records:
        outs = rec.outputs
        ins = rec.inputs
        if rec.op in CONVERT_OPS:
            src, dst = CONVERT_OPS[rec.op]
            dst_dtype = (outs[0] if dst is None else rec.args[dst]).dtype
            if rec.args[src].dtype == F64 and dst_dtype == F32:
                out.append(Finding(
                    "T006", ERROR, where,
                    f"f64 -> f32 conversion ({rec.op}) on a path feeding "
                    "Partials (precision truncation)",
                    "the scan plane runs float64 end to end; only the "
                    "float32 kernels (range_mask_agg, use_kernels=True) may "
                    "cast, and they are not on a partials-f64 path",
                ))
            continue
        if (any(o.dtype == F32 for o in outs)
                and any(i.dtype == F64 for i in ins)):
            out.append(Finding(
                "T006", ERROR, where,
                f"op '{rec.op}' produces f32 from f64 input(s): a silent "
                "precision drop (dtype drift)",
                "keep the scan plane's arithmetic in float64; look for "
                "float32 constants or tensors mixed into the path",
            ))
    for o in trace.outputs:
        if o.dtype.is_floating_point and o.dtype != F64:
            out.append(Finding(
                "T006", ERROR, where,
                f"program output has dtype {str(o.dtype).split('.')[-1]}, "
                "expected float64",
                "Partials fields are float64 by contract",
            ))
    return out


# ---------------------------------------------------------------- T007


def _snips(rng, q: int, device, l: int = 2, c: int = 1, v: int = 3):
    from repro_torch.core.types import SnippetBatch

    lo = rng.uniform(0.0, 0.6, (q, l))
    return SnippetBatch.from_numpy(
        lo, lo + rng.uniform(0.1, 0.4, (q, l)),
        rng.uniform(size=(q, c, v)) < 0.8, np.ones(q, np.int32),
        np.zeros(q, np.int32), device)


def _shape_sig(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else a for a in args)


def improve_dispatch(synopsis, new, raw):
    """The port's improve dispatch: ``Synopsis.improve`` pads ``new`` to
    its Q bucket and serves from the state padded to its fill bucket."""
    return synopsis.improve(new, raw)


def gp_signature(call: dict) -> tuple:
    """A call of ``gp_batch_infer`` as its launch sees it: argument shapes
    and dtypes, the compute dtype and the launch plan (the built library's
    on the card, the wrapper's mirror on the CPU)."""
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops

    names = ("k_mat", "sigma_inv", "alpha", "kappa2", "mu_new", "raw_theta",
             "raw_beta2")
    k = call["k_mat"]
    q_n, c_n = k.shape
    plan = (gp_ops.gp_plan_of_library if k.device.type == "cuda"
            else gp_ops.gp_plan)(q_n, c_n, call["live"])
    return _shape_sig([call[n] for n in names]) + (call["dtype"],
                                                   tuple(plan))


def check_improve_cache_cardinality(
    dispatch: Optional[Callable] = None,
    q_values: Sequence[int] = (3, 8, 12, 20),
    fill_values: Sequence[int] = (5, 8, 13, 27),
    device=None,
) -> List[Finding]:
    """T007: one ``gp_batch_infer`` launch signature per (Q-bucket,
    fill-bucket) pair.

    For each fill a ``Synopsis`` (synchronous ingest) takes that many
    snippets; ``dispatch(synopsis, new, raw)`` (``improve_dispatch``, or a
    fixture) then serves each Q. More signatures than distinct bucket
    pairs means an unpadded size reached the kernel's launch.
    """
    from repro_torch.core.synopsis import Synopsis
    from repro_torch.core.types import RawAnswer, Schema, bucket_size
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops

    dev = resolve_device(device)
    fn = improve_dispatch if dispatch is None else dispatch
    where = "program:improve_ladder"
    schema = Schema(num_lo=(0.0, 0.0), num_hi=(1.0, 1.0), cat_sizes=(3,),
                    n_measures=1)
    rng = np.random.default_rng(0)
    capacity = 2 * bucket_size(max(fill_values))
    buckets, sigs = set(), set()
    for fill in fill_values:
        syn = Synopsis(schema, capacity=capacity, async_ingest=False,
                       device=dev)
        syn.add(_snips(rng, fill, dev), rng.uniform(0.2, 0.8, fill),
                np.full(fill, 1e-3))
        if syn.n != fill:
            return [Finding(
                "T007", ERROR, where,
                f"the ladder's synopsis holds {syn.n} of {fill} snippets",
                "the ladder needs distinct snippets with finite answers")]
        for q in q_values:
            buckets.add((bucket_size(q, syn.min_q_bucket),
                         bucket_size(fill, syn.min_fill_bucket)))
            raw = RawAnswer(torch.full((q,), 0.5, dtype=F64, device=dev),
                            torch.full((q,), 1e-2, dtype=F64, device=dev))
            with CallTap(gp_ops.gp_batch_infer) as tap:
                fn(syn, _snips(rng, q, dev), raw)
            sigs.update(gp_signature(call) for _, call in tap.calls)
    if len(sigs) == len(buckets):
        return []
    return [Finding(
        "T007", ERROR, where,
        f"(Q, fill) ladder over {len(q_values)}x{len(fill_values)} calls "
        f"reached gp_batch_infer with {len(sigs)} launch signature(s); "
        f"expected exactly {len(buckets)} (one per bucket pair "
        f"{sorted(buckets)})",
        "a launch must depend only on the PADDED shapes (and the fill's "
        "bucket through live=); a leaked unpadded size launches per call "
        "instead of per bucket",
    )]


def k1_signature(call: dict) -> tuple:
    """A call of ``fused_masked_scan`` as its launches see it: argument
    shapes and dtypes and, on the card, the built library's plan of each
    measure group."""
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops

    x, codes, cat = call["x"], call["codes"], call["cat"]
    sig = _shape_sig([call[n] for n in ("x", "codes", "measures", "lo", "hi",
                                        "cat", "valid")])
    if x.device.type != "cuda":
        return sig
    t_n, l = x.shape
    q_n, c, v = cat.shape
    return sig + tuple(
        tuple(fms_ops.fused_scan_plan(t_n, q_n, count, l, c, v))
        for _, count in fms_ops.measure_groups(call["measures"].shape[1]))


def check_scan_launch_cache(device=None) -> List[Finding]:
    """T007 (scan leg): K1's launch is keyed by shape alone: the same
    shape twice is one signature, a new shape a second."""
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops

    dev = resolve_device(device)
    where = "program:eval_partials_fused"
    rng = np.random.default_rng(1)
    num = torch.zeros((4, 2), dtype=F64, device=dev)
    cat = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    meas = torch.zeros((4, 1), dtype=F64, device=dev)
    snips = _snips(rng, 2, dev)
    with CallTap(fms_ops.fused_masked_scan) as tap:
        fms_ops.eval_partials_fused(num, cat, meas, snips)
        fms_ops.eval_partials_fused(num, cat, meas, snips)
        after_same = len({k1_signature(c) for _, c in tap.calls})
        fms_ops.eval_partials_fused(num[:3], cat[:3], meas[:3], snips)
        after_new = len({k1_signature(c) for _, c in tap.calls})
    if after_same == 1 and after_new == 2:
        return []
    return [Finding(
        "T007", ERROR, where,
        f"fused_masked_scan launch signatures drifted: {after_same} after "
        f"two same-shape calls (expected 1), {after_new} after one new "
        "shape (expected 2)",
        "K1's launch (and its plan) must be a function of the shapes alone",
    )]


# ------------------------------------------------------------ running them

TRACE_RULES = ("T001", "T002", "T003", "T004", "T005", "T006", "T007")


def run_trace_rules(programs: Optional[Iterable[Program]] = None,
                    rules: Optional[Sequence[str]] = None,
                    device=None) -> List[Finding]:
    """All trace-layer findings over the engine's programs on ``device``
    (``None``: the card), or over a custom set of programs."""
    rules = set(TRACE_RULES if rules is None else rules)
    if programs is None:
        dev = resolve_device(device)
        progs = engine_programs(dev)
    else:
        progs = list(programs)
    out: List[Finding] = []
    for p in progs:
        if "fold-dot" in p.tags and "T001" in rules:
            out.extend(check_fold_dot_shapes(p))
        if "fold-order" in p.tags and "T002" in rules:
            out.extend(check_fold_order(p))
        if "mask-build" in p.tags and "T003" in rules:
            out.extend(check_mask_build_collectives(p))
        if "agg" in p.tags and "T004" in rules:
            out.extend(check_agg_collectives(p))
        if "fused" in p.tags and "T005" in rules:
            out.extend(check_no_tq_buffer(p))
        if "partials-f64" in p.tags and "T006" in rules:
            out.extend(check_partials_f64(p))
    if "T007" in rules and programs is None:
        out.extend(check_improve_cache_cardinality(device=dev))
        out.extend(check_scan_launch_cache(device=dev))
    return out
