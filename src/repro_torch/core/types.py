"""Core types for Database Learning (Verdict), in PyTorch.

The unit of inference is the *query snippet* (paper Definition 1): a supported
aggregate query whose answer is a single scalar. Snippets are stored as a
struct-of-arrays ``SnippetBatch`` of tensors, so covariance construction,
inference and aggregation are batched.

Numeric predicate ranges are normalized to the attribute domain ([0, 1] per
dimension) at ingestion. The core math runs in float64 (the reference runs
with ``jax_enable_x64``): every tensor here is made with an explicit
``dtype`` and ``device``; nothing relies on ``torch.set_default_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import tracing
from repro_torch.utils.stats import confidence_multiplier

AVG = 0
FREQ = 1

F64 = torch.float64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Fails loudly when CUDA is asked for (explicitly or by default) and no
    card is present — the port never carries on on the CPU unasked.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (or pass-through for array-likes). The query
    path's copies from the device all come through here, and are counted
    (``host_copy.count``, ``host_copy.bytes``) while tracing is on."""
    if isinstance(x, torch.Tensor):
        tracing.host_copy(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Static description of the (denormalized) relation the engine serves.

    ``num_lo/num_hi``: domain bounds of the ``l`` numeric dimension attributes.
    ``cat_sizes``: domain cardinality of each of the ``c`` categorical dimension
    attributes; ``cat_vmax`` is the padded one-hot width (>= max(cat_sizes)).
    ``n_measures``: number of measure attributes (AVG targets).
    """

    num_lo: Tuple[float, ...]
    num_hi: Tuple[float, ...]
    cat_sizes: Tuple[int, ...]
    n_measures: int
    cat_vmax: int = 0
    num_names: Tuple[str, ...] = ()
    cat_names: Tuple[str, ...] = ()
    measure_names: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.cat_vmax == 0 and self.cat_sizes:
            object.__setattr__(self, "cat_vmax", int(max(self.cat_sizes)))

    @property
    def n_num(self) -> int:
        return len(self.num_lo)

    @property
    def n_cat(self) -> int:
        return len(self.cat_sizes)

    def normalize(self, dim: int, value):
        lo, hi = self.num_lo[dim], self.num_hi[dim]
        return (value - lo) / max(hi - lo, 1e-300)

    def denormalize(self, dim: int, value):
        lo, hi = self.num_lo[dim], self.num_hi[dim]
        return value * (hi - lo) + lo


@dataclasses.dataclass
class SnippetBatch:
    """A batch of query snippets, vectorized (struct of tensors).

    lo, hi    : (n, l) f64 — normalized numeric range constraints (defaults 0/1)
    cat       : (n, c, V) bool — categorical membership masks (all-True = free)
    agg       : (n,) i32 — AVG / FREQ
    measure   : (n,) i32 — measure attribute index (0 for FREQ)
    """

    lo: torch.Tensor
    hi: torch.Tensor
    cat: torch.Tensor
    agg: torch.Tensor
    measure: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.lo.shape[0])

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def __getitem__(self, idx) -> "SnippetBatch":
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        elif isinstance(idx, np.ndarray):
            idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        return SnippetBatch(self.lo[idx], self.hi[idx], self.cat[idx],
                            self.agg[idx], self.measure[idx])

    def to(self, device) -> "SnippetBatch":
        device = torch.device(device)
        if self.device == device:
            return self
        return SnippetBatch(*(getattr(self, f).to(device)
                              for f in ("lo", "hi", "cat", "agg", "measure")))

    def numpy(self) -> tuple:
        """(lo, hi, cat, agg, measure) host arrays."""
        return tuple(to_numpy(getattr(self, f))
                     for f in ("lo", "hi", "cat", "agg", "measure"))

    @staticmethod
    def from_numpy(lo, hi, cat, agg, measure, device) -> "SnippetBatch":
        return SnippetBatch(
            lo=torch.as_tensor(np.asarray(lo, np.float64), device=device),
            hi=torch.as_tensor(np.asarray(hi, np.float64), device=device),
            cat=torch.as_tensor(np.asarray(cat, bool), device=device),
            agg=torch.as_tensor(np.asarray(agg, np.int32), device=device),
            measure=torch.as_tensor(np.asarray(measure, np.int32),
                                    device=device),
        )

    @staticmethod
    def concat(batches) -> "SnippetBatch":
        return SnippetBatch(*(torch.cat([getattr(b, f) for b in batches])
                              for f in ("lo", "hi", "cat", "agg", "measure")))

    @staticmethod
    def empty(schema: Schema, device="cpu") -> "SnippetBatch":
        l, c, v = schema.n_num, schema.n_cat, schema.cat_vmax
        return SnippetBatch(
            lo=torch.zeros((0, l), dtype=F64, device=device),
            hi=torch.ones((0, l), dtype=F64, device=device),
            cat=torch.ones((0, c, max(v, 1)), dtype=torch.bool, device=device),
            agg=torch.zeros((0,), dtype=torch.int32, device=device),
            measure=torch.zeros((0,), dtype=torch.int32, device=device),
        )


SNIPPET_TILE = 128


def bucket_size(n: int, minimum: int = 8, cap: Optional[int] = None) -> int:
    """Smallest power-of-two tile >= max(n, minimum), optionally clamped to cap.

    The shape-bucketing rule shared by the serve path; ``cap`` (the synopsis
    capacity) bounds the largest bucket; since n <= cap always, the clamped
    bucket still covers n.
    """
    b = max(int(minimum), 1)
    n = int(n)
    while b < n:
        b *= 2
    if cap is not None:
        b = min(b, int(cap))
    return b


def snippet_key(lo, hi, cat, agg, measure) -> int:
    """Content hash of one snippet (host-side numpy rows).

    The shared dedup key: ``Synopsis`` uses it for LRU/replacement bookkeeping
    and the plan IR uses it to fuse identical snippets across queries.
    """
    return hash(
        (lo.tobytes(), hi.tobytes(), cat.tobytes(), int(agg), int(measure))
    )


def pad_snippets(snippets: SnippetBatch,
                 multiple: int = SNIPPET_TILE) -> SnippetBatch:
    """Pad the snippet axis up to the next multiple of ``multiple``.

    Each snippet's partials are independent of its sibling columns, so the
    padding never changes a real snippet's answer. Padding rows are
    full-domain FREQ snippets; callers slice them away.
    """
    n = snippets.n
    target = max(((n + multiple - 1) // multiple) * multiple, multiple)
    if target == n:
        return snippets
    k = target - n
    l = snippets.lo.shape[1]
    c, v = snippets.cat.shape[1], snippets.cat.shape[2]
    dev = snippets.device
    return SnippetBatch(
        lo=torch.cat([snippets.lo, torch.zeros((k, l), dtype=F64, device=dev)]),
        hi=torch.cat([snippets.hi, torch.ones((k, l), dtype=F64, device=dev)]),
        cat=torch.cat([snippets.cat,
                       torch.ones((k, c, v), dtype=torch.bool, device=dev)]),
        agg=torch.cat([snippets.agg,
                       torch.full((k,), FREQ, dtype=torch.int32, device=dev)]),
        measure=torch.cat([snippets.measure,
                           torch.zeros((k,), dtype=torch.int32, device=dev)]),
    )


def make_snippets(
    schema: Schema,
    *,
    agg,
    measure=None,
    num_ranges=None,
    cat_sets=None,
    device="cpu",
) -> SnippetBatch:
    """Build a SnippetBatch from python-level predicate descriptions.

    num_ranges: list (len n) of dict {dim: (lo, hi)} in RAW attribute units.
    cat_sets:   list (len n) of dict {dim: iterable of category ids}.
    agg:        int or list of ints; measure likewise.
    The batch is built on the host (planning metadata); ``device`` places it.
    """
    # An explicitly-empty list is a valid 0-snippet batch (e.g. decompose()
    # over zero groups); only None means "one unconstrained snippet".
    if num_ranges is None:
        num_ranges = [{}]
    n = len(num_ranges)
    if cat_sets is None:
        cat_sets = [{} for _ in range(n)]
    if len(cat_sets) != n:
        raise ValueError("num_ranges and cat_sets length mismatch")
    l, c, v = schema.n_num, schema.n_cat, max(schema.cat_vmax, 1)
    lo = np.zeros((n, l))
    hi = np.ones((n, l))
    cat = np.zeros((n, c, v), dtype=bool)
    for k, size in enumerate(schema.cat_sizes):
        cat[:, k, :size] = True
    for i, ranges in enumerate(num_ranges):
        for dim, (a, b) in ranges.items():
            lo[i, dim] = schema.normalize(dim, a)
            hi[i, dim] = schema.normalize(dim, b)
    for i, sets in enumerate(cat_sets):
        for dim, values in sets.items():
            cat[i, dim, :] = False
            for val in values:
                cat[i, dim, int(val)] = True
    agg_arr = (np.full((n,), agg, np.int32) if np.isscalar(agg)
               else np.asarray(agg, np.int32).reshape(n))
    if measure is None:
        measure = 0
    mea_arr = (
        np.full((n,), measure, np.int32)
        if np.isscalar(measure)
        else np.asarray(measure, np.int32).reshape(n)
    )
    return SnippetBatch.from_numpy(lo, hi, cat, agg_arr, mea_arr, device)


@dataclasses.dataclass
class GPParams:
    """Correlation parameters of one aggregate function g (paper §4.2, App. A/F.3).

    log_ls     : (l,) log lengthscales (normalized units)
    log_sigma2 : () log of sigma_g^2
    mu         : () prior mean (AVG: answer units; FREQ: density units)
    """

    log_ls: torch.Tensor
    log_sigma2: torch.Tensor
    mu: torch.Tensor

    @property
    def ls(self):
        return torch.exp(self.log_ls)

    @property
    def sigma2(self):
        return torch.exp(self.log_sigma2)

    def to(self, device) -> "GPParams":
        return GPParams(self.log_ls.to(device), self.log_sigma2.to(device),
                        self.mu.to(device))

    @staticmethod
    def init(schema: Schema, sigma2=1.0, mu=0.0, device="cpu") -> "GPParams":
        # Paper App. A: starting lengthscale = attribute range (=1.0 normalized).
        return GPParams(
            log_ls=torch.zeros((schema.n_num,), dtype=F64, device=device),
            log_sigma2=torch.log(torch.tensor(float(sigma2), dtype=F64,
                                              device=device)),
            mu=torch.tensor(float(mu), dtype=F64, device=device),
        )


@dataclasses.dataclass
class RawAnswer:
    """AQP engine output for a batch of snippets: theta_i and beta_i^2."""

    theta: torch.Tensor  # (n,)
    beta2: torch.Tensor  # (n,)


@dataclasses.dataclass
class ImprovedAnswer:
    """Verdict output: improved answer/error plus bookkeeping.

    accepted: bool per snippet — whether the model-based answer passed validation
    (False ⇒ theta/beta2 are the raw values, paper §3.2 / Appendix B).
    """

    theta: torch.Tensor
    beta2: torch.Tensor
    raw_theta: torch.Tensor
    raw_beta2: torch.Tensor
    accepted: torch.Tensor

    def error_bound(self, delta: float = 0.95) -> torch.Tensor:
        """Half-width of the improved answers' ``delta`` confidence interval
        (alpha_delta * beta), on their device."""
        from repro_torch.utils.stats import confidence_multiplier

        return confidence_multiplier(delta) * torch.sqrt(self.beta2)
