"""Representative-shape programs of the scan plane, and the recorder that
traces them, for ``repro_torch.analysis.trace_rules``.

The parity and performance contracts of the scan plane (the 512 x 128
canonical fold, its ascending order, the shard-local mask build, the fused
scan's (T, Q)-mask-free footprint, float64 end to end) are properties of
what the programs run, not of their Python source. Eager PyTorch has no
jaxpr or StableHLO to read, so a program is traced by running it once, on
real tensors made from a seed, under ``Recorder``: a ``TorchDispatchMode``
that records every aten op (its inputs and outputs: shapes, dtypes,
devices, strides, storage offsets, and an identity per tensor so that a
dataflow can be followed). The representative shape is deliberately
awkward (tuple and snippet counts that are not tile multiples), so every
padding branch runs.

A kernel launched through a ``ctypes`` wrapper is invisible to the
recorder; the tensors its wrapper allocates (outputs, scratch) are seen,
and so is its launch counter (``kernels.count_launch``), whose change over
the run each trace keeps. On the card a trace also keeps the run's peak of
allocated device memory above its start.

Python calls are observed, where a rule needs them, through
``sys.setprofile`` (``CallTap``), never by patching a module: the shard
slices that ``executor.place_shards`` returns are labelled that way, and
the improve ladder's launches of ``gp_batch_infer`` are read that way.

Every program carries *tags* naming which rules apply:

``fold-dot``     the canonical tuple-axis fold: every product over the tuple
                 axis is a fixed (128, 512) x (512, P) product.
``fold-order``   the fold is an ascending left fold.
``partials-f64`` feeds ``Partials``: float64 end to end, no float64 to
                 float32 truncation anywhere on the path.
``mask-build``   the sharded predicate-mask build: no op combines the rows
                 of two shards.
``agg``          an aggregation program: at most ``PSUM_BOUND`` ops combine
                 the rows of two shards.
``fused``        the fused-kernel path: no tensor as large as (T, Q) is
                 created, and on the card the run's peak memory stays below
                 T * Q * 8 bytes.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.types import F64, SnippetBatch, resolve_device

# Representative shape: every axis tile-unaligned, so the programs run the
# padding and multi-tile structure (T pads to 1536 = 3 tuple tiles, Q pads
# to 256 = 2 snippet tiles).
REP_T = 1500  # tuples per block
REP_Q = 200  # snippets per fused batch
REP_L = 2  # numeric dimension attributes
REP_C = 1  # categorical dimension attributes
REP_V = 3  # padded one-hot width
REP_M = 2  # measure attributes
REP_GP_C = 64  # past snippets of the gp_batch_infer program

# Ops combining the rows of several shards that an aggregation program may
# hold. The design needs none (the gathered mask is reduced on one device,
# in the plain fold's order); a per-shard partial reduction would be
# allowed one.
PSUM_BOUND = 1

# Logical shards of the mask-build program's mesh: the program's device
# listed this many times, as the reference forces 8 host devices.
N_SHARDS = 8

# Kernels that fold the tuple axis inside a launch (K1 and K4).
FOLD_KERNELS = ("fused_masked_scan", "masked_partials")


class TensorInfo(NamedTuple):
    """What the recorder keeps of one tensor at one op (never the tensor)."""

    uid: int  # identity: one number per tensor object over the trace
    shape: tuple
    dtype: torch.dtype
    device: str
    stride: tuple
    offset: int  # storage offset, in elements


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of a traced run: its arguments as given (tensors as
    ``TensorInfo``, lists as tuples) and its tensor results."""

    op: str  # e.g. "aten.mm.default"
    args: tuple
    kwargs: dict
    outputs: tuple  # TensorInfo of each tensor result
    pointwise: bool  # the op carries torch.Tag.pointwise
    view: bool  # the op returns a view of an input

    @property
    def inputs(self) -> List[TensorInfo]:
        """Every tensor argument, in order (lists flattened)."""
        out: List[TensorInfo] = []

        def visit(v):
            if isinstance(v, TensorInfo):
                out.append(v)
            elif isinstance(v, tuple):
                for x in v:
                    visit(x)

        visit(self.args)
        visit(tuple(self.kwargs.values()))
        return out


class Recorder(TorchDispatchMode):
    """Records every aten op run under it, on this thread."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self._uids = WeakIdKeyDictionary()  # tensor -> uid, never kept alive
        self._next = 0

    def uid(self, t: torch.Tensor) -> int:
        u = self._uids.get(t)
        if u is None:
            u = self._uids[t] = self._next
            self._next += 1
        return u

    def describe(self, v):
        if isinstance(v, torch.Tensor):
            return TensorInfo(self.uid(v), tuple(v.shape), v.dtype,
                              str(v.device), tuple(v.stride()),
                              v.storage_offset())
        if isinstance(v, (list, tuple)):
            return tuple(self.describe(x) for x in v)
        return v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        args_d = self.describe(args)
        kwargs_d = {k: self.describe(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        res = out if isinstance(out, (list, tuple)) else (out,)
        self.records.append(OpRecord(
            str(func), args_d, kwargs_d,
            tuple(self.describe(r) for r in res
                  if isinstance(r, torch.Tensor)),
            torch.Tag.pointwise in func.tags, bool(func.is_view)))
        return out


class CallTap:
    """The calls of chosen Python functions made on this thread while the
    tap is open: each call's arguments on entry (``calls``) and its return
    value (``returns``), as ``(function, value)`` in order.

    Read through ``sys.setprofile``, so nothing is patched: a kernel
    wrapper, which counts its launches on itself, keeps counting there. The
    profile function in place before the tap is put back when it closes.
    """

    def __init__(self, *fns: Callable):
        self._fns = {fn.__code__: fn for fn in fns}
        self.calls: list = []
        self.returns: list = []
        self._prev = None

    def _hook(self, frame, event, arg):
        fn = self._fns.get(frame.f_code)
        if fn is None:
            return
        if event == "call":
            self.calls.append((fn, dict(frame.f_locals)))
        elif event == "return":
            self.returns.append((fn, arg))

    def __enter__(self) -> "CallTap":
        self._prev = sys.getprofile()
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(self._prev)
        return False


@dataclasses.dataclass
class Trace:
    """One traced run of a program."""

    records: List[OpRecord]
    outputs: List[TensorInfo]  # the program's tensor results
    shards: Dict[int, int]  # uid -> shard index, of every place_shards slice
    launches: Dict[str, int]  # kernel -> launches during the run (nonzero)
    peak_bytes: Optional[int]  # card: peak allocated above the start


def _leaves(v) -> list:
    """The tensors of a program's result (tensors, tuples, lists, dicts,
    dataclasses such as ``Partials``)."""
    if isinstance(v, torch.Tensor):
        return [v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        v = [getattr(v, f.name) for f in dataclasses.fields(v)]
    elif isinstance(v, dict):
        v = list(v.values())
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _leaves(x)]
    return []


def kernel_wrappers() -> frozenset:
    """The public kernel wrappers a program may be: on the CPU each runs
    its kernel's plain version, so a CPU trace sees that plain version."""
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops
    from repro_torch.kernels.range_mask_agg import ops as rma_ops
    from repro_torch.kernels.se_covariance import ops as se_ops

    return frozenset({
        fms_ops.eval_partials_fused, fms_ops.masked_partials_fused,
        fms_ops.fused_masked_scan, fms_ops.masked_partials,
        rma_ops.eval_partials_kernel, se_ops.se_cov_matrix,
        gp_ops.gp_batch_infer})


@dataclasses.dataclass
class Program:
    """One scan-plane program on real tensors, plus its rule tags."""

    name: str
    fn: Callable
    args: tuple
    tags: frozenset
    # The true (unpadded) block shape the args describe: what the
    # no-(T, Q)-buffer rule measures against.
    t: int = REP_T
    q: int = REP_Q
    device: torch.device = torch.device("cpu")
    _trace: Optional[Trace] = None

    @property
    def plain_stand_in(self) -> bool:
        """A kernel wrapper traced on the CPU, where it runs its plain
        version by design."""
        return (torch.device(self.device).type == "cpu"
                and self.fn in kernel_wrappers())

    def trace(self) -> Trace:
        """Run the program once under the recorder (cached)."""
        if self._trace is None:
            self._trace = run_traced(self.fn, self.args, self.device)
        return self._trace


def run_traced(fn: Callable, args: tuple, device) -> Trace:
    """Run ``fn(*args)`` once under a ``Recorder`` and a ``CallTap`` on
    ``executor.place_shards``; on the card, synchronised, with the peak of
    allocated memory above its start."""
    from repro_torch import kernels
    from repro_torch.aqp import executor

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    before = kernels.launch_counts()
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec = Recorder()
    with CallTap(executor.place_shards) as tap, rec:
        result = fn(*args)
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    after = kernels.launch_counts()
    shards = {}
    for _, placed in tap.returns:
        for i, arrays in enumerate(placed or ()):
            for a in arrays:
                shards[rec.uid(a)] = i
    return Trace(rec.records, [rec.describe(t) for t in _leaves(result)],
                 shards,
                 {k: after[k] - before[k] for k in after
                  if after[k] != before[k]},
                 peak)


# ------------------------------------------------------------ the programs


def rep_block(device, t: int = REP_T, seed: int = 0):
    """(num_normalized, cat, measures, valid) of one tuple block."""
    rng = np.random.default_rng(seed)
    num = rng.uniform(0.0, 1.0, (t, REP_L))
    cat = rng.integers(0, REP_V, (t, REP_C)).astype(np.int32)
    meas = rng.normal(1.0, 2.0, (t, REP_M))
    valid = (rng.uniform(size=t) < 0.9).astype(np.float64)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (num, cat, meas, valid))


def rep_snippets(device, q: int = REP_Q, seed: int = 1) -> SnippetBatch:
    """``q`` snippets over the representative block's dims."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.6, (q, REP_L))
    hi = lo + rng.uniform(0.05, 0.4, (q, REP_L))
    cat = rng.uniform(size=(q, REP_C, REP_V)) < 0.7
    agg = rng.integers(0, 2, q).astype(np.int32)
    measure = rng.integers(0, REP_M, q).astype(np.int32)
    return SnippetBatch.from_numpy(lo, hi, cat, agg, measure, device)


def sharded_mask_program(device, n_shards: int = N_SHARDS,
                         seed: int = 0) -> Program:
    """``executor.sharded_mask`` over a ``Mesh`` that lists ``device``
    ``n_shards`` times, on the padded block ``eval_partials_sharded``
    hands it (the tuple axis padded to the mesh's power-of-two tile)."""
    from repro_torch.aqp import executor

    dev = resolve_device(device)
    num, cat, _, valid = rep_block(dev, seed=seed)
    num_p, cat_p, _, valid_p = executor.pad_tuple_axis(n_shards, num, cat,
                                                       None, valid)
    mesh = executor.Mesh((dev,) * n_shards)
    return Program(
        "sharded_mask_build", functools.partial(executor.sharded_mask, mesh),
        (num_p, cat_p, rep_snippets(dev, seed=seed + 1), valid_p),
        frozenset({"mask-build", "partials-f64"}),
        t=executor.padded_tuple_count(REP_T, n_shards), device=dev)


def engine_programs(device=None, seed: int = 0) -> List[Program]:
    """The scan plane's programs at the representative shape on ``device``
    (``None``: the card). The set mirrors the bitwise-parity contract
    surface: the canonical fold and its consumers (the plain scan, the
    gathered-mask fold, the fused kernel), the sharded mask build, and the
    remaining public kernel wrappers."""
    from repro_torch.aqp import executor
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops
    from repro_torch.kernels.range_mask_agg import ops as rma_ops
    from repro_torch.kernels.se_covariance import ops as se_ops

    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 2)

    def put(a):
        return torch.as_tensor(a, device=dev)

    num, cat, meas, valid = rep_block(dev, seed=seed)
    snips = rep_snippets(dev, seed=seed + 1)
    mask = put((rng.uniform(size=(REP_T, REP_Q)) < 0.3).astype(np.float64))
    payload = put(rng.normal(size=(REP_T, 2 * REP_M + 1)))
    scanned = valid.sum()
    block = (num, cat, meas, snips, valid)
    sym = rng.normal(scale=0.01, size=(REP_GP_C, REP_GP_C))
    gp_args = (put(rng.normal(scale=0.1, size=(REP_Q, REP_GP_C))),
               put(np.eye(REP_GP_C) + sym + sym.T),
               put(rng.normal(size=REP_GP_C)),
               put(rng.uniform(1.0, 2.0, REP_Q)), put(rng.normal(size=REP_Q)),
               put(rng.normal(size=REP_Q)), put(rng.uniform(0.1, 1.0, REP_Q)))
    other = rep_snippets(dev, seed=seed + 3)
    se_args = (snips.lo, snips.hi, other.lo, other.hi,
               torch.full((REP_L,), 0.5, dtype=F64, device=dev), 1.0,
               put(rng.uniform(0.5, 1.5, REP_Q)),
               put(rng.uniform(0.5, 1.5, REP_Q)))
    tags = frozenset
    return [
        Program("masked_tile_fold", executor.masked_tile_fold,
                (mask, payload),
                tags({"fold-dot", "fold-order", "partials-f64"}), device=dev),
        Program("_partials_from_mask", executor._partials_from_mask,
                (mask, meas, snips, scanned),
                tags({"fold-dot", "fold-order", "partials-f64", "agg"}),
                device=dev),
        Program("eval_partials", executor.eval_partials, block,
                tags({"fold-dot", "fold-order", "partials-f64"}), device=dev),
        # The fused scan: on the card its fold runs inside K1, where no
        # trace sees its order; the fold shape (on the CPU), the f64 policy
        # and the no-(T, Q) contract are checked.
        Program("eval_partials_fused", fms_ops.eval_partials_fused, block,
                tags({"fold-dot", "partials-f64", "fused"}), device=dev),
        Program("masked_partials_fused", fms_ops.masked_partials_fused,
                (mask, meas, snips, scanned),
                tags({"fold-dot", "partials-f64", "agg"}), device=dev),
        # K5 accumulates in float32 by design and casts back at the
        # epilogue; as in the reference it is held to the shard rule only.
        Program("range_mask_agg.eval_partials_kernel",
                rma_ops.eval_partials_kernel, block, tags({"agg"}),
                device=dev),
        Program("se_cov_matrix", se_ops.se_cov_matrix, se_args,
                tags({"agg"}), device=dev),
        Program("gp_batch_infer", gp_ops.gp_batch_infer, gp_args,
                tags({"agg"}), device=dev),
        sharded_mask_program(dev, seed=seed),
    ]


def by_tag(programs: List[Program]) -> Dict[str, List[Program]]:
    out: Dict[str, List[Program]] = {}
    for p in programs:
        for tag in p.tags:
            out.setdefault(tag, []).append(p)
    return out
