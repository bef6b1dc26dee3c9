"""Snippet evaluation over tuple blocks + CLT error bounds.

The plain form of a multi-snippet scan builds a (tuples × snippets)
predicate mask and folds it against ``[measures, measures², 1]``. That plain
form lives here (``predicate_mask``, ``masked_tile_fold``, ``eval_partials``).
Every scan of a local block goes through the ``fused_masked_scan`` kernel
wrapper (``repro_torch.kernels.fused_masked_scan.ops.eval_partials_fused``):
on the card its kernel, which never writes the mask to memory; on the CPU
its plain version, which is this plain form bit for bit.
``predicate_mask`` also serves group-by discovery, which the reference
computes outside any kernel too.

``masked_tile_fold`` is the canonical reduction of the plain scan: fixed
(SCAN_TILE_T × SCAN_TILE_Q) tiles folded in ascending tuple-tile order. Its
fixed-shape tile products make each snippet's partials bitwise independent
of how many snippets ride along (Q-padding) on a given backend.

Distribution (``ShardedScanPlacement``): a tuple block of any size runs over
a ``Mesh`` of any size. The tuple axis is padded to a power-of-two tile
divisible by the mesh, padding rows carry a validity mask (so
``Partials.scanned`` is the mask sum, never the padded shape), and each
shard's predicate mask is built on its own device in plain PyTorch. The
masks are gathered onto the mesh's first device and folded there: on the
card by the ``masked_partials`` kernel, which folds in the fused scan's own
order, so a sharded block gives bitwise the local block's partials; on the
CPU by that kernel's plain version, bitwise ``eval_partials``. The mesh is
one process's devices (the reference's placement is single-controller
too); a mesh may list one device several times, each entry a logical
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.types import AVG, F64, SnippetBatch, resolve_device
from repro_torch.ft import faults
from repro_torch.kernels import RANGE_EPS, SCAN_TILE_Q, SCAN_TILE_T

BIG_BETA2 = 1e12  # raw error for snippets with no support in the scanned sample


@dataclasses.dataclass(frozen=True)
class Partials:
    """Sufficient statistics accumulated over scanned tuples."""

    sums: torch.Tensor  # (n,) sum of measure over matching tuples
    sumsq: torch.Tensor  # (n,)
    count: torch.Tensor  # (n,) matching tuples
    scanned: torch.Tensor  # () total VALID tuples scanned (mask sum)

    def __add__(self, other: "Partials") -> "Partials":
        return Partials(
            self.sums + other.sums,
            self.sumsq + other.sumsq,
            self.count + other.count,
            self.scanned + other.scanned,
        )


def snippet_mask(x, codes, lo, hi, cat, valid=None):
    """(T, n) float64 mask: ``lo − RANGE_EPS ≤ x ≤ hi + RANGE_EPS`` on every
    numeric dim, AND categorical membership, times ``valid``.

    x: (T, l) normalized units; codes: (T, c) int; lo/hi: (n, l);
    cat: (n, c, V) bool; valid: optional (T,) 0/1 — invalid (padding) rows
    are forced to exactly 0.0 in every column.
    """
    mask = ((x[:, None, :] >= lo[None, :, :] - RANGE_EPS)
            & (x[:, None, :] <= hi[None, :, :] + RANGE_EPS)).all(-1)
    c = codes.shape[1] if codes.dim() == 2 else 0
    for k in range(c):
        # cat[:, k, :]: (n, V); codes[:, k]: (T,)
        mk = cat[:, k, :].index_select(1, codes[:, k].long())  # (n, T)
        mask = mask & mk.T
    mask = mask.to(F64)
    if valid is not None:
        mask = mask * valid[:, None]
    return mask


def predicate_mask(num_normalized, cat, snippets: SnippetBatch, valid=None):
    """(T, n) float64 mask of tuples satisfying each snippet's predicates."""
    return snippet_mask(num_normalized, cat, snippets.lo, snippets.hi,
                        snippets.cat, valid)


def masked_tile_fold(mask, payload, tile_t: int = SCAN_TILE_T,
                     tile_q: int = SCAN_TILE_Q):
    """out[q, p] = sum_t mask[t, q] * payload[t, p], folded per snippet tile
    over fixed (tile_t, tile_q) tiles in ascending tuple-tile order.

    Zero-pads both axes to tile multiples; padding contributes exact zeros
    and is sliced away. Every tile product has the same fixed shape, so a
    snippet's partials do not depend on how many snippets ride along.
    """
    t, q = mask.shape
    p = payload.shape[1]
    pad_t = (-t) % tile_t
    pad_q = (-q) % tile_q
    if pad_t:
        mask = torch.cat([mask, mask.new_zeros((pad_t, q))])
        payload = torch.cat([payload, payload.new_zeros((pad_t, p))])
    if pad_q:
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], pad_q))], 1)
    cols = []
    for j in range(mask.shape[1] // tile_q):
        sq = slice(j * tile_q, (j + 1) * tile_q)
        acc = None
        for i in range(mask.shape[0] // tile_t):
            st = slice(i * tile_t, (i + 1) * tile_t)
            part = mask[st, sq].T @ payload[st]
            acc = part if acc is None else acc + part
        if acc is None:  # zero-row block
            acc = payload.new_zeros((tile_q, p))
        cols.append(acc)
    out = torch.cat(cols) if cols else payload.new_zeros((0, p))
    return out[:q]


def payload_of(measures):
    """The scan payload ``[measures, measures², 1]``: (T, 2m+1)."""
    t = measures.shape[0]
    return torch.cat([measures, measures * measures,
                      measures.new_ones((t, 1))], 1)


def partials_from_columns(out, snippets: SnippetBatch, m: int,
                          scanned) -> Partials:
    """(n, 2m+1) accumulated columns → ``Partials``: gather each snippet's own
    measure's sum and sum of squares; the last column is the count."""
    idx = snippets.measure.long()[:, None]
    sums = out[:, :m].gather(1, idx)[:, 0]
    sumsq = out[:, m:2 * m].gather(1, idx)[:, 0]
    return Partials(sums, sumsq, out[:, 2 * m], scanned)


def _partials_from_mask(mask, measures, snippets: SnippetBatch,
                        scanned) -> Partials:
    """The mask → sufficient-statistics aggregation of the plain scan."""
    out = masked_tile_fold(mask, payload_of(measures))  # (n, 2m+1)
    return partials_from_columns(out, snippets, measures.shape[1], scanned)


def eval_partials(num_normalized, cat, measures, snippets: SnippetBatch,
                  valid=None) -> Partials:
    """Partial statistics for one tuple block — the plain PyTorch scan.

    ``valid``: optional (T,) validity mask for zero-padded tuple blocks.
    Padding rows contribute exactly nothing, and ``scanned`` is the mask
    sum — the true number of tuples scanned, not the padded shape.
    """
    mask = predicate_mask(num_normalized, cat, snippets, valid)  # (T, n)
    scanned = (torch.tensor(float(num_normalized.shape[0]), dtype=F64,
                            device=num_normalized.device)
               if valid is None else valid.sum())
    return _partials_from_mask(mask, measures, snippets, scanned)


def padded_tuple_count(t: int, n_shards: int) -> int:
    """Tuple-axis tile for a ``t``-row block over ``n_shards`` shards: the
    smallest power of two >= t, rounded up to a multiple of the shard
    count (a no-op for power-of-two meshes)."""
    n_shards = max(int(n_shards), 1)
    b = 1
    while b < t:
        b *= 2
    return -(-b // n_shards) * n_shards


def pad_tuple_axis(n_shards: int, num_normalized, cat, measures, valid=None):
    """Zero-pad the tuple axis to ``padded_tuple_count`` rows.

    Returns ``(num, cat, measures, valid)`` where ``valid`` marks the
    original rows with 1.0 and the padding with 0.0 (an existing ``valid``
    is extended). Padding payloads are zeros and categorical codes pad with
    0, an in-domain index: the validity mask is what keeps them out.
    ``measures`` may be None (the mask stage does not read the payload).
    """
    t = num_normalized.shape[0]
    if valid is None:
        valid = torch.ones((t,), dtype=F64, device=num_normalized.device)
    k = padded_tuple_count(t, n_shards) - t
    if k == 0:
        return num_normalized, cat, measures, valid
    return (
        torch.cat([num_normalized,
                   num_normalized.new_zeros((k, num_normalized.shape[1]))]),
        torch.cat([cat, cat.new_zeros((k, cat.shape[1]))]),
        None if measures is None else
        torch.cat([measures, measures.new_zeros((k, measures.shape[1]))]),
        torch.cat([valid, valid.new_zeros((k,))]),
    )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of torch devices, the port's stand-in for
    ``jax.sharding.Mesh``.

    Each entry of ``devices`` is one logical shard; a device may be listed
    several times (one CUDA card, or the CPU, split into shards). Devices
    are resolved as every entry point resolves them: ``"cuda"`` means the
    current card, and a CUDA device with no card present fails loudly.
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError("a Mesh has exactly one axis, got "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def place_shards(mesh: Mesh, num_normalized, cat, valid):
    """Split a padded block's mask-stage arrays into ``len(mesh.devices)``
    equal shards, shard ``i`` on ``mesh.devices[i]``: a list of
    ``(num, cat, valid)``. The measure payload never moves."""
    n = len(mesh.devices)
    rows = num_normalized.shape[0] // n
    return [tuple(a[i * rows:(i + 1) * rows].to(dev)
                  for a in (num_normalized, cat, valid))
            for i, dev in enumerate(mesh.devices)]


def sharded_mask(mesh: Mesh, num_normalized, cat, snippets: SnippetBatch,
                 valid=None):
    """The mask stage of a sharded block: ``(mask, scanned)``.

    The tuple axis is padded with a validity mask (``pad_tuple_axis``) and
    split over the mesh (``place_shards``); each shard's predicate mask is
    built on its own device, and the masks of the true rows are gathered
    onto ``mesh.devices[0]`` as one (T, n) mask. ``scanned`` is the
    validity-mask sum: a shard made only of padding adds nothing.
    """
    t = num_normalized.shape[0]
    num_p, cat_p, _, valid_p = pad_tuple_axis(
        len(mesh.devices), num_normalized, cat, None, valid)
    shards = place_shards(mesh, num_p, cat_p, valid_p)
    home = mesh.devices[0]
    masks = [predicate_mask(num_s, cat_s, snippets.to(num_s.device),
                            valid_s).to(home)
             for num_s, cat_s, valid_s in shards]
    return torch.cat(masks)[:t], valid_p.sum()


def eval_partials_sharded(mesh: Mesh, num_normalized, cat, measures,
                          snippets: SnippetBatch, valid=None) -> Partials:
    """Partials of one block over the mesh's one axis, for any (tuple
    count, mesh size): the gathered mask of ``sharded_mask`` folded by the
    ``masked_partials`` kernel's wrapper — the kernel on the card, its
    plain version (bitwise the plain fold) on the CPU."""
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops

    mask, scanned = sharded_mask(mesh, num_normalized, cat, snippets, valid)
    return fms_ops.masked_partials_fused(mask, measures, snippets, scanned)


def _evaluator_name(local_eval, device) -> str:
    """Stable name of what a per-block evaluator runs on ``device``, for
    placement telemetry. On the CPU the fused scan's wrapper runs its plain
    version, which is the plain scan bit for bit: that is ``oracle``."""
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops
    from repro_torch.kernels.range_mask_agg import ops as rma_ops

    on_card = torch.device(device).type == "cuda"
    if local_eval is eval_partials or (
            local_eval is fms_ops.eval_partials_fused and not on_card):
        return "oracle"
    if local_eval is fms_ops.eval_partials_fused:
        return "fused_masked_scan"
    if local_eval is rma_ops.eval_partials_kernel:
        return "range_mask_agg"
    return getattr(local_eval, "__name__", "custom")


class ScanPlacement:
    """Placement seam of the scan plane (local placement).

    Owns where tuple blocks live and how a block is evaluated; the query
    lifecycle only calls ``eval_block`` with the engine's per-block
    evaluator (``local_eval``, by default the ``fused_masked_scan`` kernel's
    wrapper: the kernel on the card, its plain version on the CPU).
    ``ShardedScanPlacement`` pads, masks and splits over a mesh.
    """

    kind = "local"
    mesh = None
    axis = "data"

    def __init__(self):
        self.blocks_evaluated = 0
        self.pad_rows = 0  # padding rows appended across all blocks
        self.tuples_placed = 0  # true (valid) tuples routed through eval
        self.last_evaluator = None  # evaluator actually used by eval_block

    @property
    def n_shards(self) -> int:
        return 1

    def describe(self) -> str:
        """Human-readable placement (``Session.explain``/``stats``)."""
        return "local"

    def place(self, num_normalized, cat, valid):
        """Shards of one (padded) block's mask-stage arrays, as a list of
        ``(num, cat, valid)``; local placement is one shard, unmoved."""
        return [(num_normalized, cat, valid)]

    def evaluator_for(self, local_eval, device) -> str:
        """Name of what ``eval_block`` runs for ``local_eval`` on a block on
        ``device`` — what ``Session.explain`` reports before any block
        runs."""
        return _evaluator_name(local_eval, device)

    def eval_block(self, block, snippets: SnippetBatch,
                   local_eval=None) -> Partials:
        """Partials for one tuple block through this placement."""
        from repro_torch.kernels.fused_masked_scan import ops as fms_ops

        faults.fire("scan.eval")  # seam: before dispatch, state untouched
        fn = local_eval or fms_ops.eval_partials_fused
        self.blocks_evaluated += 1
        self.tuples_placed += int(block.num_normalized.shape[0])
        self.last_evaluator = self.evaluator_for(fn, block.measures.device)
        return fn(block.num_normalized, block.cat, block.measures, snippets)

    def stats(self) -> dict:
        """Operator-facing snapshot of the scan plane's placement."""
        return {
            "kind": self.kind,
            "n_shards": self.n_shards,
            "axis": self.axis,
            "blocks_evaluated": self.blocks_evaluated,
            "tuples_scanned": self.tuples_placed,
            "pad_rows": self.pad_rows,
            "evaluator": self.last_evaluator,
        }


class ShardedScanPlacement(ScanPlacement):
    """Tuple blocks split over the axis of a ``Mesh`` and evaluated through
    ``eval_partials_sharded``: any block size over any mesh size, bitwise
    equal to the local placement."""

    kind = "sharded"

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        self.axis = mesh.axis_names[0]

    @property
    def n_shards(self) -> int:
        return len(self.mesh.devices)

    def describe(self) -> str:
        return f"sharded:{self.n_shards}x{self.axis}"

    def place(self, num_normalized, cat, valid):
        """Split the (padded) tuple axis over the mesh devices."""
        return place_shards(self.mesh, num_normalized, cat, valid)

    def evaluator_for(self, local_eval, device) -> str:
        """The mask is always built shard by shard, whatever ``local_eval``
        is, and the gathered mask is folded on the mesh's first device: by
        the ``masked_partials`` kernel on the card, plainly on the CPU."""
        if self.mesh.devices[0].type == "cuda":
            return "sharded_mask+kernel_agg"
        return "sharded_mask+oracle_agg"

    def eval_block(self, block, snippets: SnippetBatch,
                   local_eval=None) -> Partials:
        faults.fire("scan.eval")  # same seam as the local placement
        t = int(block.num_normalized.shape[0])
        self.blocks_evaluated += 1
        self.tuples_placed += t
        self.pad_rows += padded_tuple_count(t, self.n_shards) - t
        self.last_evaluator = self.evaluator_for(local_eval,
                                                 self.mesh.devices[0])
        return eval_partials_sharded(
            self.mesh, block.num_normalized, block.cat, block.measures,
            snippets)


def scan_placement(mesh=None) -> ScanPlacement:
    """The placement for an optional mesh (the ``connect`` wiring)."""
    if mesh is None:
        return ScanPlacement()
    return ShardedScanPlacement(mesh)


def estimates_from_partials(parts: Partials, snippets: SnippetBatch,
                            exact: bool = False):
    """CLT raw answers (theta_i, beta_i^2) from accumulated partials.

    FREQ: p_hat = count/scanned, beta^2 = p(1-p)/scanned.
    AVG:  x_bar = sum/count,     beta^2 = sample_var/count.
    ``exact=True`` zeroes the errors (used for ground-truth evaluation).
    """
    scanned = torch.clamp(parts.scanned, min=1.0)
    cnt = parts.count
    p_hat = cnt / scanned
    freq_beta2 = p_hat * (1.0 - p_hat) / scanned

    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = parts.sums / safe_cnt
    var = torch.clamp(parts.sumsq / safe_cnt - mean * mean, min=0.0)
    avg_beta2 = var / safe_cnt

    is_avg = snippets.agg == AVG
    theta = torch.where(is_avg, mean, p_hat)
    beta2 = torch.where(is_avg, avg_beta2, freq_beta2)
    no_support = is_avg & (cnt < 2)
    theta = torch.where(no_support, torch.zeros_like(theta), theta)
    beta2 = torch.where(no_support, torch.full_like(beta2, BIG_BETA2), beta2)
    if exact:
        beta2 = torch.zeros_like(beta2)
    return theta, beta2, ~no_support
