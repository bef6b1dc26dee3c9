"""Query synopsis: bounded store of past snippets + incremental model state.

Paper §2.3: per aggregate function g the synopsis retains at most C_g snippets
(LRU replacement). The covariance matrix Sigma_n (raw-answer covariances) and
its inverse are maintained *incrementally* in O(n^2 k) per blocked insert/evict
using the block matrix-inversion lemma, with a periodic full refactor to bound
numerical drift.

Serving (``improve``) runs against device-resident buffers padded to
**fill-level buckets** (powers of two, clamped to capacity): padding rows
carry k = 0, Sigma^{-1} = I and alpha = 0, which leaves every product
untouched. On a CUDA device ``improve`` always goes through the
``gp_batch_infer`` kernel — in float64, or in float32 when the engine asks
for the reference kernel's precision (``use_kernels=True``).

Learning never blocks serving: ``add`` snapshots the raw answers to host
memory and enqueues them on a background ingest thread (``_IngestQueue``)
which runs the covariance builds and blocked inverse updates off the critical
path. ``drain()`` is the explicit barrier; every reader of model state drains
first, so the post-drain state is bitwise identical to synchronous ingestion.

Failure never blocks serving either: a failed apply **quarantines** this
synopsis — the failed batch and everything after it are parked unapplied
(FIFO), ``drain()`` stays a plain barrier, ``improve`` returns the raw sample
estimate (Theorem 1's floor), and ``state_dict`` refuses with a typed
``SynopsisQuarantinedError``. ``heal()`` restores a consistent model (from a
last-good state, or ``rebuild()`` from the row arrays) and replays the parked
batches in order.

Host/device split: the row arrays, the LRU bookkeeping and Sigma_n live on
the host (numpy, as in the reference); Sigma_n^{-1}, alpha, the GP
parameters and the serve buffers live on ``device``.
"""
from __future__ import annotations

import atexit
import collections
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core import covariance, inference, learning, validation
from repro_torch.core.append import AppendStats, adjust_answers
from repro_torch.core.types import (
    F64,
    FREQ,
    GPParams,
    ImprovedAnswer,
    RawAnswer,
    Schema,
    SnippetBatch,
    bucket_size,
    pad_snippets,
    resolve_device,
    snippet_key,
    to_numpy,
)
from repro_torch.ft import faults
from repro_torch.kernels.gp_batch_infer import ops as gp_ops
from repro_torch.utils import tracing

REFACTOR_EVERY = 128  # full O(n^3) rebuild cadence (numerical hygiene)
JITTER = 1e-10

# Smallest serve-path tiles: fills/batches below these share one shape.
MIN_FILL_BUCKET = 8
MIN_Q_BUCKET = 8


def inv_append_block(ainv, cols, block, jitter=JITTER):
    """O(m^2 k + k^3) inverse update appending k rows/cols at once.

    Blocked matrix-inversion lemma (rank-k): given A^{-1} for the current
    (m, m) covariance, the inverse of [[A, Bᵀ], [B, D]] is assembled from the
    Schur complement S = D - B A^{-1} Bᵀ.

    cols:  (k, m) covariance of the new rows against the existing ones (B).
    block: (k, k) covariance among the new rows, noise included on the
           diagonal (D).

    Returns None when the Schur complement, as computed, is not positive
    definite. Its true value is (it is a noise variance plus a conditional
    variance), so a non-positive eigenvalue means rounding has eaten it:
    with sample sizes of 10^5 tuples and more the noise variances are
    ~1e-7 and Sigma is badly conditioned. The caller then rebuilds the
    inverse from Sigma. (Clamping the eigenvalue to the jitter instead
    puts ~1e10 into the inverse, and the error grows by orders of magnitude
    with every later update until it overflows.)
    """
    k = block.shape[0]
    m = ainv.shape[0]
    u = cols @ ainv  # (k, m) = B A^{-1}
    s = block - u @ cols.T  # Schur complement
    s = 0.5 * (s + s.T)
    w, v = torch.linalg.eigh(s)
    if not bool(w.min() > 0.0):
        return None
    sinv = (v / (w + jitter)) @ v.T
    ust = u.T @ sinv  # (m, k) = A^{-1} Bᵀ S^{-1}
    out = ainv.new_empty((m + k, m + k))
    out[:m, :m] = ainv + ust @ u
    out[:m, m:] = -ust
    out[m:, :m] = -ust.T
    out[m:, m:] = sinv
    return out


def inv_delete_block(ainv, positions):
    """O(m^2 k + k^3) inverse update deleting k rows/cols at once.

    Partitioned-inverse identity: with the inverse partitioned over
    keep/delete index sets as [[P, Q], [Qᵀ, R]], the inverse of the kept
    block of the original matrix is P - Q R^{-1} Qᵀ.
    """
    n = ainv.shape[0]
    pos = np.asarray(positions, np.int64)
    keep = np.setdiff1d(np.arange(n), pos)
    keep_t = torch.as_tensor(keep, device=ainv.device)
    pos_t = torch.as_tensor(pos, device=ainv.device)
    a = ainv[keep_t][:, keep_t]
    b = ainv[keep_t][:, pos_t]
    d = ainv[pos_t][:, pos_t]
    return a - b @ torch.linalg.solve(d, b.T)


def _improve_inputs(past: SnippetBatch, valid, params: GPParams,
                    new: SnippetBatch):
    """Covariance inputs of the improve step: (k_mat, kappa2, mu_new)."""
    k_mat = covariance.cov_matrix(new, past, params) * valid[None, :]
    kappa2 = covariance.cov_diag(new, params)
    mu_new = covariance.prior_mean(new, params)
    return k_mat, kappa2, mu_new


def _pad_raw(x, target: int, fill: float):
    """Pad a 1-D raw-answer vector up to the Q bucket (f64)."""
    k = target - x.shape[0]
    if k <= 0:
        return x
    return torch.cat([x, torch.full((k,), fill, dtype=x.dtype,
                                    device=x.device)])


# Ingest threads must be quiescent when the interpreter tears down: a worker
# still inside a device call at exit can abort the runtime. atexit runs
# before teardown, so draining here leaves the daemon threads parked in plain
# condition waits.
_LIVE_QUEUES: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _drain_live_queues():
    for q in list(_LIVE_QUEUES):
        try:
            q.drain()
        except Exception:  # noqa: BLE001 — best effort at interpreter exit
            pass


MAX_PENDING_DEFAULT = 64  # ingest back-pressure bound (pending batches)

# PyTorch loads its CUDA linear-algebra library on the process' first CUDA
# linalg call, and that loader is not thread-safe: two ingest threads making
# their first call together make one of them raise ("lazy wrapper should be
# called at most once") and quarantine its synopsis. ``_load_cuda_linalg``
# makes that first call once, under a lock, from the thread that creates a
# synopsis on the card, before any of its ingest threads starts.
_CUDA_LINALG_LOCK = threading.Lock()
_CUDA_LINALG_LOADED = False


def _load_cuda_linalg(device: torch.device):
    global _CUDA_LINALG_LOADED
    if device.type != "cuda" or _CUDA_LINALG_LOADED:
        return
    with _CUDA_LINALG_LOCK:
        if not _CUDA_LINALG_LOADED:
            torch.linalg.cholesky_ex(torch.eye(1, dtype=F64, device=device))
            _CUDA_LINALG_LOADED = True


class SynopsisQuarantinedError(RuntimeError):
    """Raised by ``state_dict`` on a quarantined synopsis: a model built on a
    half-applied batch must never checkpoint. Serving paths never raise this —
    they degrade to the raw sample estimate instead (Theorem 1's floor)."""

    def __init__(self, name: Optional[str], cause: BaseException):
        super().__init__(
            f"synopsis {name or '<unnamed>'} is quarantined "
            f"(heal() to rejoin): {cause!r}"
        )
        self.name = name
        self.cause = cause


class _IngestQueue:
    """Background applier for ``Synopsis.add`` batches.

    Batches are applied strictly in submission order, one at a time, so the
    post-``drain()`` state is bitwise identical to synchronous ingestion no
    matter how worker progress interleaves with serving. The worker thread is
    daemonic, starts lazily, and exits after an idle period.

    The queue is BOUNDED (``max_pending`` batches): ``try_submit`` refuses
    new work while the worker is that far behind, and the caller sheds to
    synchronous ingestion (drain, then apply inline — FIFO order preserved).
    ``high_water`` records the deepest backlog observed.

    The applier is ``Synopsis._guarded_apply``, which never raises, so
    ``drain()`` is ALWAYS a plain barrier.
    """

    IDLE_TIMEOUT = 5.0

    def __init__(self, apply_fn, max_pending: int = MAX_PENDING_DEFAULT):
        self._apply = apply_fn
        self.max_pending = int(max_pending)
        self.high_water = 0
        # (item, its enqueue time while tracing is on, else None) pairs
        self._pending: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._outstanding = 0
        self._thread: Optional[threading.Thread] = None
        _LIVE_QUEUES.add(self)

    def try_submit(self, item) -> bool:
        """Enqueue unless the backlog is at the bound; False means shed."""
        with self._cv:
            if self._outstanding >= self.max_pending:
                return False
            self._pending.append((item, tracing.stamp()))
            self._outstanding += 1
            self.high_water = max(self.high_water, self._outstanding)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="synopsis-ingest", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
            return True

    def _run(self):
        while True:
            with self._cv:
                while not self._pending:
                    woke = self._cv.wait(timeout=self.IDLE_TIMEOUT)
                    if not woke and not self._pending:
                        self._thread = None  # idle exit; submit() restarts
                        return
                batch = list(self._pending)
                self._pending.clear()
            for item, queued in batch:
                tracing.record("ingest.queued", queued)
                try:
                    self._apply(*item)  # guarded: quarantines, never raises
                finally:
                    with self._cv:
                        self._outstanding -= 1
                        self._cv.notify_all()

    def drain(self):
        """Barrier only: wait until the backlog is fully handed to the
        applier. Never raises."""
        with self._cv:
            while self._outstanding:
                self._cv.wait()


class Synopsis:
    """Bounded per-aggregate-function snippet store + incremental GP state.

    ``device``: the torch device the model state (Sigma^{-1} chain, alpha,
    GP parameters, serve buffers) lives on; ``None`` means the CUDA card,
    failing loudly when there is none.
    """

    def __init__(
        self,
        schema: Schema,
        capacity: int = 2000,
        delta_v: float = 0.99,
        params: Optional[GPParams] = None,
        async_ingest: bool = True,
        max_pending: int = MAX_PENDING_DEFAULT,
        device=None,
        min_fill_bucket: int = MIN_FILL_BUCKET,
        min_q_bucket: int = MIN_Q_BUCKET,
    ):
        self.schema = schema
        self.capacity = int(capacity)
        self.delta_v = float(delta_v)
        self.async_ingest = bool(async_ingest)
        self.max_pending = int(max_pending)
        self.device = resolve_device(device)
        _load_cuda_linalg(self.device)
        self.min_fill_bucket = int(min_fill_bucket)
        self.min_q_bucket = int(min_q_bucket)
        self.name: Optional[str] = None  # store-assigned state_key (fault key)
        self._shed_count = 0
        self._restored_high_water = 0
        self._qlock = threading.Lock()
        # Monotone state generation for the answer cache
        # (``repro_torch.intel``): bumped on the caller's thread at every
        # serving-visible transition — add (at enqueue, so the bump never
        # waits for async ingest), quarantine, heal, refit, append and state
        # restore. A cached answer records the generations it was computed
        # under; any mismatch marks it stale.
        self.generation = 0
        self._quarantine_exc: Optional[BaseException] = None
        self._unapplied: list = []  # parked (FIFO) batches awaiting heal()
        self._quarantine_count = 0  # quarantine episodes over this lifetime
        l, c, v = schema.n_num, schema.n_cat, max(schema.cat_vmax, 1)
        C = self.capacity
        self._lo = np.zeros((C, l))
        self._hi = np.ones((C, l))
        self._cat = np.ones((C, c, v), dtype=bool)
        self._agg = np.full((C,), FREQ, np.int32)
        self._measure = np.zeros((C,), np.int32)
        self._theta = np.zeros((C,))
        self._beta2 = np.ones((C,))
        self._stamp = np.full((C,), -1, np.int64)
        self.n = 0
        # ``n`` as it will stand once every queued add has applied, kept at
        # enqueue time (``queued_fill``), and the keys it counts while the
        # store is below capacity (none can be evicted before that).
        self._queued_n = 0
        self._queued_keys: Optional[set] = set()
        self._clock = 0
        self._keys: dict = {}
        self.params = (params.to(self.device) if params is not None
                       else GPParams.init(schema, device=self.device))
        self._sigma = np.zeros((C, C))
        self._sigma_inv = torch.zeros((0, 0), dtype=F64, device=self.device)
        self._alpha = torch.zeros((0,), dtype=F64, device=self.device)
        self._updates_since_refactor = 0
        self._order: list = []  # row ids in Sigma^{-1} ordering
        self._device_states: dict = {}  # fill bucket -> padded serve buffers
        self._ingest: Optional[_IngestQueue] = None

    # -------------------------------------------------------------- placement
    def _put(self, x) -> torch.Tensor:
        """A host array (or tensor) as a tensor on this synopsis' device."""
        return torch.as_tensor(x, device=self.device)

    # ---------------------------------------------------------------- storage
    def _row_batch(self, rows) -> SnippetBatch:
        return SnippetBatch.from_numpy(
            self._lo[rows], self._hi[rows], self._cat[rows], self._agg[rows],
            self._measure[rows], self.device)

    def theta(self) -> torch.Tensor:
        """The stored raw answers (row order), on this synopsis' device."""
        self.drain()
        return self._put(np.array(self._theta[: self.n]))

    def beta2(self) -> torch.Tensor:
        """The stored raw answers' variances (row order), on this synopsis'
        device."""
        self.drain()
        return self._put(np.array(self._beta2[: self.n]))

    @staticmethod
    def _key(lo, hi, cat, agg, measure):
        return snippet_key(lo, hi, cat, agg, measure)

    # ----------------------------------------------------------------- ingest
    def add(self, snippets: SnippetBatch, theta, beta2):
        """Insert raw answers; duplicates refresh LRU stamps and keep the more
        accurate answer.

        The host snapshot happens here (cheap copies); the covariance builds
        and blocked inverse updates run on the background ingest thread.
        ``drain()`` is the barrier; batches apply strictly in FIFO order
        (``async_ingest=False`` applies inline instead). Under overload the
        caller sheds to synchronous ingestion.
        """
        lo, hi, cat, agg, mea = snippets.numpy()
        item = (
            np.array(lo, dtype=np.float64),
            np.array(hi, dtype=np.float64),
            np.array(cat, dtype=bool),
            np.array(agg, dtype=np.int32),
            np.array(mea, dtype=np.int32),
            np.array(to_numpy(theta), dtype=np.float64),
            np.array(to_numpy(beta2), dtype=np.float64),
        )
        self._enqueued(item)
        if not self.async_ingest:
            self._guarded_apply(*item)
            return
        if self._ingest is None:
            self._ingest = _IngestQueue(self._guarded_apply,
                                        max_pending=self.max_pending)
        if not self._ingest.try_submit(item):
            self._shed_count += 1
            self._ingest.drain()  # preserve FIFO before applying inline
            self._guarded_apply(*item)

    def _enqueued(self, item):
        """Enqueue bookkeeping, on the caller's thread under the lock the
        ingest thread's quarantine takes: bump the generation (an answer
        cached right after this add records the post-ingest generation,
        whatever the ingest thread has done), and advance ``queued_fill``
        by what ``_apply_add`` will do with ``item``: each distinct finite
        key not yet stored takes a row, up to capacity (evictions then keep
        the fill at capacity)."""
        lo, hi, cat, agg, mea, theta, beta2 = item
        with self._qlock:
            self.generation += 1
            keys = self._queued_keys
            if keys is None:  # at capacity: nothing changes the fill
                return
            for i in range(lo.shape[0]):
                if np.isfinite(theta[i]) and np.isfinite(beta2[i]):
                    keys.add(self._key(lo[i], hi[i], cat[i], agg[i], mea[i]))
            self._queued_n = min(len(keys), self.capacity)
            if len(keys) >= self.capacity:
                self._queued_keys = None

    def _sync_queued(self):
        """Reset ``queued_fill`` to the applied state (nothing queued)."""
        with self._qlock:
            self._queued_n = self.n
            self._queued_keys = (set(self._keys) if self.n < self.capacity
                                 else None)

    def queued_fill(self) -> int:
        """The fill once every queued add has applied: what ``n`` reads
        under ``async_ingest=False``, known without waiting for the ingest
        thread. A quarantined synopsis counts as empty."""
        with self._qlock:
            return 0 if self._quarantine_exc is not None else self._queued_n

    def _guarded_apply(self, *item):
        """Apply one batch, quarantining on failure instead of raising."""
        with self._qlock:
            if self._quarantine_exc is not None:
                self._unapplied.append(item)
                return
        try:
            with tracing.span("ingest.apply", snippets=len(item[0])):
                self._apply_add(*item)
        except Exception as e:  # noqa: BLE001 — quarantine, never raise
            self._mark_quarantined(e, item)

    def _mark_quarantined(self, exc: BaseException, item=None):
        with self._qlock:
            if self._quarantine_exc is None:
                self._quarantine_exc = exc
                self._quarantine_count += 1
                self.generation += 1  # degraded: cached answers go stale
            if item is not None:
                self._unapplied.append(item)

    @property
    def quarantined(self) -> bool:
        """Whether this synopsis is serving degraded (raw answers only)."""
        return self._quarantine_exc is not None

    @property
    def quarantine_reason(self) -> Optional[str]:
        exc = self._quarantine_exc
        return None if exc is None else repr(exc)

    def heal(self, state: Optional[dict] = None) -> bool:
        """Rebuild a consistent model and rejoin serving.

        ``state``: a last-good ``state_dict`` snapshot to restore from;
        ``None`` rebuilds Sigma / Sigma^{-1} / alpha from this synopsis' own
        row arrays (``rebuild()``). Parked batches then replay in their
        original FIFO order. Returns True iff the synopsis is healthy
        afterwards; a replay failure re-quarantines and returns False.
        """
        if not self.quarantined:
            return True
        if self._ingest is not None:
            # Flush in-flight adds into the parked list while the flag is
            # still set (the guarded applier parks rather than applies).
            self._ingest.drain()
        with self._qlock:
            parked = list(self._unapplied)
            self._unapplied.clear()
            self._quarantine_exc = None
        try:
            if state is not None:
                self.load_state_dict(state)
            else:
                self.rebuild()
        except Exception as e:  # noqa: BLE001 — re-quarantine
            with self._qlock:
                self._quarantine_exc = e
                self._quarantine_count += 1
                self._unapplied = parked + self._unapplied
            return False
        for i, item in enumerate(parked):
            try:
                self._apply_add(*item)
            except Exception as e:  # noqa: BLE001 — re-quarantine
                with self._qlock:
                    self._quarantine_exc = e
                    self._quarantine_count += 1
                    self._unapplied = parked[i:] + self._unapplied
                return False
        self._sync_queued()
        self.generation += 1  # healed state ≠ the state cached answers saw
        return True

    def drain(self):
        """Barrier: block until every enqueued ``add`` batch has been handed
        to the (never-raising) guarded applier. NEVER raises — an injected
        barrier fault quarantines this synopsis instead."""
        try:
            faults.fire("store.drain", key=self.name)
        except Exception as e:  # noqa: BLE001 — injected barrier fault
            self._mark_quarantined(e)  # still quiesce the worker below
        if self._ingest is not None:
            self._ingest.drain()

    @property
    def ingest_high_water(self) -> int:
        """Deepest async-ingest backlog observed (batches), incl. restored."""
        live = self._ingest.high_water if self._ingest is not None else 0
        return max(live, self._restored_high_water)

    def ingest_stats(self) -> dict:
        """Back-pressure + quarantine telemetry for the ingest path."""
        with self._qlock:
            return {
                "max_pending": self.max_pending,
                "high_water": self.ingest_high_water,
                "shed_count": self._shed_count,
                "quarantined": self._quarantine_exc is not None,
                "quarantine_reason": (
                    None if self._quarantine_exc is None
                    else repr(self._quarantine_exc)
                ),
                "unapplied": len(self._unapplied),
                "quarantine_count": self._quarantine_count,
            }

    def _apply_add(self, lo, hi, cat, agg, mea, theta, beta2):
        """Synchronous ingest of one host-side batch (runs on the worker).

        Covariance columns for every genuinely-new row are built in one
        ``cov_matrix`` call and applied with one blocked rank-k inverse
        update; capacity evictions for the whole batch are applied with one
        blocked delete. Eviction victims are chosen after the whole incoming
        batch has refreshed its duplicate stamps.
        """
        faults.fire("ingest.apply", key=self.name)  # seam: before any mutation
        pending: dict = {}  # key -> [incoming index of best beta2, LRU stamp]
        for i in range(lo.shape[0]):
            if not (np.isfinite(theta[i]) and np.isfinite(beta2[i])):
                continue
            key = self._key(lo[i], hi[i], cat[i], agg[i], mea[i])
            self._clock += 1
            if key in self._keys:
                r = self._keys[key]
                self._stamp[r] = self._clock
                if beta2[i] < self._beta2[r]:
                    self._theta[r] = theta[i]
                    self._replace_beta(r, beta2[i])
                continue
            entry = pending.get(key)
            if entry is None:
                pending[key] = [i, self._clock]
            else:
                entry[1] = self._clock
                if beta2[i] < beta2[entry[0]]:
                    entry[0] = i
        # If one call brings more new snippets than the whole store holds,
        # only the most recently used ``capacity`` survive.
        new = list(pending.items())
        if len(new) > self.capacity:
            new.sort(key=lambda kv: kv[1][1])
            new = new[-self.capacity:]
        if new:
            n_evict = max(0, self.n + len(new) - self.capacity)
            free: list = []
            if n_evict:
                victims = np.argsort(self._stamp[: self.n], kind="stable")[:n_evict]
                for r in victims:
                    old_key = self._key(
                        self._lo[r], self._hi[r], self._cat[r],
                        self._agg[r], self._measure[r],
                    )
                    self._keys.pop(old_key, None)
                self._delete_block_from_model(victims)
                free = [int(r) for r in victims]
            grow = len(new) - len(free)
            slots = list(range(self.n, self.n + grow)) + free
            self.n += grow
            for (key, (i, stamp)), r in zip(new, slots):
                self._lo[r] = lo[i]
                self._hi[r] = hi[i]
                self._cat[r] = cat[i]
                self._agg[r] = agg[i]
                self._measure[r] = mea[i]
                self._theta[r] = theta[i]
                self._beta2[r] = beta2[i]
                self._stamp[r] = stamp
                self._keys[key] = r
            self._insert_block_into_model(slots)
        self._refresh_alpha()
        self._device_states.clear()

    def _replace_beta(self, r, new_beta2):
        """Diagonal-only change: redo row r in the model (delete+insert)."""
        self._delete_block_from_model([r])
        self._beta2[r] = new_beta2
        self._insert_block_into_model([r])

    # ------------------------------------------------------ incremental model
    def _cov_blocks(self, rows, prev):
        """Covariance of ``rows`` against ``prev`` and among themselves
        (host arrays), built on this synopsis' device."""
        k = len(rows)
        batch = self._row_batch(np.asarray(rows, np.int64))
        padded = pad_snippets(batch, 8)
        if len(prev):
            prev_b = pad_snippets(self._row_batch(np.asarray(prev, np.int64)),
                                  64)
            cols = to_numpy(
                covariance.cov_matrix(padded, prev_b, self.params)
            )[:k, : len(prev)]
        else:
            cols = np.zeros((k, 0))
        block = np.array(
            to_numpy(covariance.cov_matrix(padded, padded, self.params))
        )[:k, :k]
        block[np.diag_indices(k)] = (
            to_numpy(covariance.cov_diag(padded, self.params))[:k]
            + self._beta2[np.asarray(rows, np.int64)]
        )
        return cols, block

    def _insert_block_into_model(self, rows):
        """Rows were just written into free/evicted slots; append them to the
        model in one blocked update (position in the inverse == position in
        ``self._order``)."""
        rows = [int(r) for r in rows]
        prev = list(self._order)
        cols, block = self._cov_blocks(rows, prev)
        self._sigma[np.ix_(rows, prev)] = cols
        self._sigma[np.ix_(prev, rows)] = cols.T
        self._sigma[np.ix_(rows, rows)] = block
        self._updates_since_refactor += len(rows)
        self._order.extend(rows)
        sinv = None
        if self._updates_since_refactor < REFACTOR_EVERY:
            sinv = inv_append_block(self._sigma_inv, self._put(cols),
                                    self._put(block))
        if sinv is None:  # refactor cadence, or the update lost definiteness
            self._refactor()
        else:
            self._sigma_inv = sinv

    def _delete_block_from_model(self, rows):
        members = set(self._order)
        rows = [int(r) for r in rows if int(r) in members]
        if not rows:
            return
        pos = sorted(self._order.index(r) for r in rows)
        self._sigma_inv = inv_delete_block(self._sigma_inv, pos)
        for p in reversed(pos):
            self._order.pop(p)
        self._updates_since_refactor += len(pos)

    def _refactor(self):
        """Full O(n^3) rebuild of Sigma^{-1} from Sigma (numerical hygiene)."""
        rows = np.asarray(self._order, dtype=np.int64)
        if len(rows) == 0:
            self._sigma_inv = torch.zeros((0, 0), dtype=F64, device=self.device)
            self._updates_since_refactor = 0
            return
        sig = self._put(self._sigma[np.ix_(rows, rows)])
        chol = inference.factorize(sig, JITTER)
        self._sigma_inv = inference.inverse_from_chol(chol)
        self._updates_since_refactor = 0

    def _refresh_alpha(self):
        rows = np.asarray(self._order, dtype=np.int64)
        if len(rows) == 0:
            self._alpha = torch.zeros((0,), dtype=F64, device=self.device)
            return
        batch = self._row_batch(rows)
        resid = (self._put(self._theta[rows])
                 - covariance.prior_mean(batch, self.params))
        self._alpha = self._sigma_inv @ resid

    # ------------------------------------------------------------------ refit
    def refit(self, steps: int = 150, lr: float = 0.1,
              learn_sigma: bool = False) -> GPParams:
        """Offline learning (Appendix A): relearn params, rebuild the model.

        Drains first. A quarantined synopsis skips refit (its row arrays may
        hold a half-applied batch, so learning waits for ``heal()``), and so
        does one with fewer than 3 rows; either returns its params as they
        are. The fit runs on this synopsis' device.
        """
        self.drain()
        if self.quarantined or self.n < 3:
            return self.params
        rows = np.asarray(self._order, dtype=np.int64)
        batch = self._row_batch(rows)
        self.params, _ = learning.fit(
            batch, self._put(self._theta[rows]), self._put(self._beta2[rows]),
            self.schema, steps=steps, lr=lr, learn_sigma=learn_sigma)
        self.rebuild()
        self.generation += 1  # relearned params change improved answers
        return self.params

    # ------------------------------------------------------------- append (D)
    def apply_append(self, stats: AppendStats):
        """Adjust all stored answers for appended data (Appendix D, Lemma 3),
        then rebuild the model. Drains first."""
        self.drain()
        if self.n == 0:
            return
        n = self.n
        theta, beta2 = adjust_answers(
            *(torch.from_numpy(a[:n]) for a in (self._theta, self._beta2,
                                                self._measure, self._agg)),
            stats)
        self._theta[:n] = theta.numpy()
        self._beta2[:n] = beta2.numpy()
        self.rebuild()
        self.generation += 1  # stored answers rescaled for appended data

    def rebuild(self):
        """Recompute Sigma for the current params, refactor, refresh alpha."""
        self.drain()
        rows = np.asarray(self._order, dtype=np.int64)
        if len(rows):
            batch = self._row_batch(rows)
            sig = np.array(to_numpy(
                covariance.cov_matrix(batch, batch, self.params)))
            sig[np.diag_indices(len(rows))] = to_numpy(
                covariance.cov_diag(batch, self.params)
            ) + self._beta2[rows]
            self._sigma[np.ix_(rows, rows)] = sig
        self._refactor()
        self._refresh_alpha()
        self._device_states.clear()

    # ------------------------------------------------------------------ serve
    def _fill_bucket(self) -> int:
        """Power-of-two serve tile covering the current fill (<= capacity)."""
        return bucket_size(self.n, self.min_fill_bucket, cap=self.capacity)

    def _padded_state(self, bucket: Optional[int] = None):
        """Device-resident buffers padded to a fill bucket, cached per bucket.

        Padding rows carry k = 0 (valid mask), Sigma^{-1} = I and alpha = 0,
        leaving every product untouched. Built on the device directly: the
        inverse never round-trips through the host.
        """
        bucket = self._fill_bucket() if bucket is None else int(bucket)
        state = self._device_states.get(bucket)
        if state is not None:
            return state
        rows = np.asarray(self._order, dtype=np.int64)
        n = len(rows)
        idx = np.concatenate([rows, np.zeros((bucket - n,), np.int64)])
        past = self._row_batch(idx)
        valid = self._put(np.asarray(np.arange(bucket) < n, np.float64))
        sinv = torch.eye(bucket, dtype=F64, device=self.device)
        alpha = torch.zeros((bucket,), dtype=F64, device=self.device)
        if n:
            sinv[:n, :n] = self._sigma_inv
            alpha[:n] = self._alpha
        state = (past, valid, sinv, alpha)
        self._device_states[bucket] = state
        return state

    def improve(self, new: SnippetBatch, raw: RawAnswer,
                use_kernel: bool = False) -> ImprovedAnswer:
        """Improved answers for a batch of new snippets (Algorithm 2 lines 3-7).

        Drains pending ingest first, then serves from the bucketed device
        state through ``gp_batch_infer``: float64 by default, float32 (the
        reference kernel's precision) with ``use_kernel=True``. Validation
        (Appendix B) applies either way, in float64.
        """
        self.drain()
        if self.n == 0 or self.quarantined:
            # Empty synopsis (Theorem 1's equality case) or quarantined
            # (degraded mode): return raw unchanged.
            acc = torch.zeros((new.n,), dtype=torch.bool,
                              device=raw.theta.device)
            return ImprovedAnswer(raw.theta, raw.beta2, raw.theta, raw.beta2,
                                  acc)
        q = new.n
        qb = bucket_size(q, self.min_q_bucket)
        padded_new = pad_snippets(new.to(self.device), qb)
        raw_theta = _pad_raw(raw.theta.to(self.device, F64), qb, 0.0)
        raw_beta2 = _pad_raw(raw.beta2.to(self.device, F64), qb, 1.0)
        past, valid, sinv, alpha = self._padded_state()
        k_mat, kappa2, mu_new = _improve_inputs(past, valid, self.params,
                                                padded_new)
        # K is zero past the fill: the kernel's split follows the fill's own
        # bucket, so a raised fill floor (padding) never moves a bit.
        m_theta, m_beta2, _ = gp_ops.gp_batch_infer(
            k_mat, sinv, alpha, kappa2, mu_new, raw_theta, raw_beta2,
            dtype=torch.float32 if use_kernel else F64, live=self.n)
        theta, beta2, accepted = validation.validate(
            padded_new.agg, m_theta.to(F64), m_beta2.to(F64), raw_theta,
            raw_beta2, self.delta_v)
        return ImprovedAnswer(
            theta[:q], beta2[:q], raw.theta, raw.beta2, accepted[:q]
        )

    # ------------------------------------------------------------ persistence
    def state_dict(self):
        """Host snapshot of the learned state (drains pending ingest first).

        Every array is a copy. The layout is the reference's, so a snapshot
        from either package loads into the other. Raises
        ``SynopsisQuarantinedError`` while quarantined.
        """
        self.drain()
        if self.quarantined:
            raise SynopsisQuarantinedError(self.name, self._quarantine_exc)
        n = self.n
        return {
            "lo": np.array(self._lo[:n]),
            "hi": np.array(self._hi[:n]),
            "cat": np.array(self._cat[:n]),
            "agg": np.array(self._agg[:n]),
            "measure": np.array(self._measure[:n]),
            "theta": np.array(self._theta[:n]),
            "beta2": np.array(self._beta2[:n]),
            "stamp": np.array(self._stamp[:n]),
            "order": np.asarray(self._order, np.int64),
            "log_ls": to_numpy(self.params.log_ls).copy(),
            "log_sigma2": np.array(to_numpy(self.params.log_sigma2)),
            "mu": np.array(to_numpy(self.params.mu)),
            "ingest_high_water": np.asarray(self.ingest_high_water, np.int64),
        }

    def load_state_dict(self, state):
        """Restore a snapshot (numpy arrays, the reference's layout) and
        rebuild Sigma, Sigma^{-1} and alpha on this synopsis' device."""
        self.drain()
        if "ingest_high_water" in state:  # absent in pre-back-pressure dumps
            self._restored_high_water = int(state["ingest_high_water"])
        n = np.asarray(state["lo"]).shape[0]
        self.n = n
        self._lo[:n] = state["lo"]
        self._hi[:n] = state["hi"]
        self._cat[:n] = state["cat"]
        self._agg[:n] = state["agg"]
        self._measure[:n] = state["measure"]
        self._theta[:n] = state["theta"]
        self._beta2[:n] = state["beta2"]
        self._stamp[:n] = state["stamp"]
        self._order = [int(x) for x in np.asarray(state["order"])]
        self.params = GPParams(
            log_ls=self._put(np.asarray(state["log_ls"], np.float64)),
            log_sigma2=self._put(np.asarray(state["log_sigma2"], np.float64)),
            mu=self._put(np.asarray(state["mu"], np.float64)),
        )
        self._keys = {
            self._key(self._lo[i], self._hi[i], self._cat[i], self._agg[i],
                      self._measure[i]): i
            for i in range(n)
        }
        self._clock = int(self._stamp[:n].max()) if n else 0
        self._sync_queued()
        self.rebuild()
        self.generation += 1  # restored state ≠ whatever answers were cached
