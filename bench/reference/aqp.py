"""The plain reference of an approximate-query cell.

Written from the semantics, not from the port: it imports nothing of
``repro_torch`` and takes nothing the program built. From the benchmark it
reads the relation's raw columns (which the benchmark drew and handed to
both sides), the queries in the order the engine ran them and each query's
``batches_used``; from the program, only the answers it judges.

What it does, in plain PyTorch and NumPy, all in float64:

1. Draws the uniform sample again from the engine's seed: ``k =
   round(N * rate)`` rows by ``numpy.random.default_rng(seed).choice(N, k,
   replace=False)``, then a permutation of them dealt round-robin into
   ``n_batches`` batches (as ``aqp/sampler.py`` documents).
2. Decomposes each query into snippets (paper section 2.3): per group, an
   AVG snippet per measure that AVG or SUM reads and one FREQ snippet for
   SUM or COUNT. Group-by values are those with a tuple in the first sample
   batch, sorted.
3. Computes every snippet's partial sums per sample batch with a mask and a
   matrix product, and the CLT raw answers after a query's batches.
4. Replays the learning: one synopsis per aggregate key (FREQ; AVG of each
   measure) holding at most ``capacity`` past raw answers, least recently
   used out first, a repeated snippet keeping its smaller variance.
5. Improves a judged query's snippets from the synopsis as it stood when
   the engine improved them (every earlier query recorded, none later):
   the GP posterior with the squared-exponential covariance of Eq. 10
   (lengthscale 1, sigma^2 1, prior mean 0 in normalised units, a nugget of
   1e-10), solved by a fresh Cholesky factorisation, blended with the raw
   answer (Eq. 12) and validated at ``delta_v`` (Appendix B).
6. Computes the exact answers of the judged cells over the whole relation.

A configuration with ``"learning": false`` (the paper's NoLearn engine)
skips steps 4 and 5: every answer is the raw one. ``raw_answers`` gives the
raw answers of chosen queries as the program would report them, computed
in another precision: in float32 it stands in the program's place as the
control of such a configuration.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

F64 = torch.float64
RANGE_EPS = 1e-12  # a predicate's boundary slack, in normalised units
EPS_WIDTH = 1e-6  # an equality range's width in the covariance
NUGGET = 1e-10  # added to the diagonal of the past answers' covariance
GAMMA_FLOOR = 1e-30
BIG_BETA2 = 1e12  # the variance of an AVG snippet with under two tuples
SQRT_PI = math.sqrt(math.pi)
AVG, FREQ = "AVG", "FREQ"


def z_of(delta: float) -> float:
    """The two-sided normal multiplier at confidence ``delta``."""
    d = torch.as_tensor(float(delta), dtype=F64)
    return math.sqrt(2.0) * float(torch.special.erfinv(d))


def draw_sample(n_rows: int, rate: float, n_batches: int, seed: int):
    """The sample's relation rows, batch by batch: a list of int64 arrays."""
    rng = np.random.default_rng(seed)
    k = max(int(round(n_rows * rate)), 1)
    rows = rng.choice(n_rows, size=k, replace=False)
    order = rng.permutation(k)
    return [rows[order[i::n_batches]] for i in range(n_batches)
            if len(order[i::n_batches])]


@dataclasses.dataclass
class Snippet:
    """One scalar sub-query: AVG of a measure, or FREQ, over a box."""

    lo: np.ndarray  # (l,) normalised
    hi: np.ndarray
    cat: np.ndarray  # (c, V) bool
    agg: str
    measure: int  # 0 for FREQ

    def key(self):
        return (self.lo.tobytes(), self.hi.tobytes(), self.cat.tobytes(),
                self.agg, self.measure)

    @property
    def synopsis(self):
        return (self.agg, self.measure)


@dataclasses.dataclass
class Decomposed:
    """A query's snippets for every candidate group, and its cells.

    ``groups``: candidate group tuples; ``rows[g]``: {(agg, measure):
    snippet id} of group ``g``; ``cells``: (agg index, kind, measure)."""

    groups: List[tuple]
    rows: List[Dict[tuple, int]]
    cells: List[tuple]


class AqpReference:
    def __init__(self, config: dict, columns: dict, engine_seed: int,
                 dtype=F64):
        sch = config["schema"]
        self.lo = np.asarray([c["lo"] for c in sch["numeric"]], np.float64)
        self.hi = np.asarray([c["hi"] for c in sch["numeric"]], np.float64)
        self.cat_sizes = [int(c["size"]) for c in sch["categorical"]]
        self.vmax = max(self.cat_sizes) if self.cat_sizes else 1
        self.n_measures = len(sch["measures"])
        eng = config["engine"]
        self.capacity = int(eng["capacity"])
        self.n_max = int(eng["n_max"])
        self.z_valid = z_of(eng["delta_v"])
        self.z_report = z_of(eng["report_delta"])
        self.learning = bool(eng.get("learning", True))
        self.dtype = dtype  # of the scan and the raw answers
        self.num = columns["num"].to(dtype)
        self.cat = columns["cat"]
        self.measures = columns["measures"].to(dtype)
        self.device = self.num.device
        self.n_rows = int(self.num.shape[0])
        self.batches = draw_sample(self.n_rows, eng["sample_rate"],
                                   int(eng["n_batches"]), engine_seed)
        self.snippets: List[Snippet] = []
        self._ids: Dict[tuple, int] = {}

    # ---------------------------------------------------------- snippets
    def normalise(self, dim: int, value: float) -> float:
        return (value - self.lo[dim]) / max(self.hi[dim] - self.lo[dim],
                                            1e-300)

    def _snippet(self, ranges, cats, agg, measure) -> int:
        l = len(self.lo)
        lo, hi = np.zeros(l), np.ones(l)
        for dim, (a, b) in ranges.items():
            lo[dim], hi[dim] = self.normalise(dim, a), self.normalise(dim, b)
        cat = np.zeros((len(self.cat_sizes), self.vmax), bool)
        for k, size in enumerate(self.cat_sizes):
            cat[k, :size] = True
        for dim, values in cats.items():
            cat[dim, :] = False
            cat[dim, list(values)] = True
        s = Snippet(lo, hi, cat, agg, measure)
        sid = self._ids.get(s.key())
        if sid is None:
            sid = self._ids[s.key()] = len(self.snippets)
            self.snippets.append(s)
        return sid

    def decompose(self, spec) -> Decomposed:
        ranges: Dict[int, tuple] = {}
        for dim, a, b in spec.ranges:
            lo, hi = ranges.get(dim, (self.lo[dim], self.hi[dim]))
            ranges[dim] = (max(lo, a), min(hi, b))
        cats: Dict[int, set] = {}
        for dim, v in spec.eqs:
            cats[dim] = cats.get(dim, {v}) & {v}
        cells, needs = [], []
        for ai, (kind, m) in enumerate(spec.aggs):
            if kind not in ("AVG", "SUM", "COUNT"):
                raise NotImplementedError(f"aggregate {kind}")
            cells.append((ai, kind, m))
            if kind in ("AVG", "SUM") and m is not None:
                needs.append((AVG, m))
            if kind in ("SUM", "COUNT"):
                needs.append((FREQ, 0))
        groups = (list(itertools.product(
            *(range(self.cat_sizes[d]) for d in spec.groupby)))
            if spec.groupby else [()])
        rows = []
        for g in groups:
            c = dict(cats)
            for dim, v in zip(spec.groupby, g):
                c[dim] = c.get(dim, {v}) & {v}
            r = {}
            for need in dict.fromkeys(needs):
                r[need] = self._snippet(ranges, c, *need)
            if (FREQ, 0) not in r:  # the group probe counts tuples
                r[(FREQ, 0)] = self._snippet(ranges, c, FREQ, 0)
            rows.append(r)
        return Decomposed(groups, rows, cells)

    # ---------------------------------------------------------- scanning
    def _tensors(self, ids: Sequence[int]):
        s = [self.snippets[i] for i in ids]
        dev = self.device
        return (torch.as_tensor(np.stack([x.lo for x in s]), device=dev),
                torch.as_tensor(np.stack([x.hi for x in s]), device=dev),
                torch.as_tensor(np.stack([x.cat for x in s]), device=dev),
                torch.as_tensor([x.measure for x in s], device=dev))

    def partials(self, ids: Sequence[int], rows, chunk_s: int = 2048,
                 elements: int = 1 << 25) -> torch.Tensor:
        """(len(ids), 3): [count, sum, sum of squares] of each snippet's own
        measure over relation ``rows`` (an int64 array; None: every row)."""
        dt = self.dtype
        lo_n = torch.as_tensor(self.lo, dtype=dt, device=self.device)
        span = torch.as_tensor(np.maximum(self.hi - self.lo, 1e-30),
                               dtype=dt, device=self.device)
        out = torch.zeros((len(ids), 3), dtype=dt, device=self.device)
        n = self.n_rows if rows is None else len(rows)
        idx_all = (None if rows is None
                   else torch.as_tensor(rows, device=self.device))
        m = self.n_measures
        for s0 in range(0, len(ids), chunk_s):
            sl = slice(s0, min(s0 + chunk_s, len(ids)))
            lo, hi, cat, mea = self._tensors(ids[sl])
            lo, hi = lo.to(dt), hi.to(dt)
            chunk_t = min(max(elements // lo.shape[0], 1 << 12), 1 << 22)
            acc = torch.zeros((lo.shape[0], 2 * m + 1), dtype=dt,
                              device=self.device)
            for t0 in range(0, n, chunk_t):
                if idx_all is None:
                    tr = slice(t0, min(t0 + chunk_t, n))
                    x, codes, v = self.num[tr], self.cat[tr], self.measures[tr]
                else:
                    i = idx_all[t0:t0 + chunk_t]
                    x, codes, v = self.num[i], self.cat[i], self.measures[i]
                xn = (x - lo_n) / span
                mask = ((xn[:, None, :] >= lo[None] - RANGE_EPS)
                        & (xn[:, None, :] <= hi[None] + RANGE_EPS)).all(-1)
                for k in range(codes.shape[1]):
                    mask &= cat[:, k, :].index_select(
                        1, codes[:, k].long()).T
                payload = torch.cat([v, v * v, torch.ones_like(v[:, :1])], 1)
                acc += mask.to(dt).T @ payload
            ar = torch.arange(lo.shape[0], device=self.device)
            out[sl, 0] = acc[:, 2 * m]
            out[sl, 1] = acc[ar, mea.long()]
            out[sl, 2] = acc[ar, m + mea.long()]
        return out

    def batch_partials(self, ids: Sequence[int]) -> torch.Tensor:
        """(n_batches, len(ids), 3) partials, cumulative over batches."""
        per = torch.stack([self.partials(ids, b) for b in self.batches])
        return per.cumsum(0)

    def scanned(self, b: int) -> int:
        return int(sum(len(x) for x in self.batches[:b]))

    @staticmethod
    def estimates(parts: np.ndarray, aggs: Sequence[str], scanned: float):
        """CLT raw answers (theta, beta2) from [count, sum, sumsq] rows."""
        cnt, s, sq = parts[:, 0], parts[:, 1], parts[:, 2]
        n = max(float(scanned), 1.0)
        p = cnt / n
        freq_b2 = p * (1.0 - p) / n
        safe = np.maximum(cnt, 1.0)
        mean = s / safe
        var = np.maximum(sq / safe - mean * mean, 0.0)
        is_avg = np.asarray([a == AVG for a in aggs])
        theta = np.where(is_avg, mean, p)
        beta2 = np.where(is_avg, var / safe, freq_b2)
        none = is_avg & (cnt < 2)
        return np.where(none, 0.0, theta), np.where(none, BIG_BETA2, beta2)

    # ---------------------------------------------------------- the model
    def _cov(self, a: Sequence[int], b: Sequence[int], diag: bool = False):
        """Eq. 10 between snippet sets ``a`` and ``b`` (``diag``: the
        prior variance of each of ``a``)."""
        lo_a, hi_a, cat_a, _ = self._tensors(a)
        w_a = torch.clamp(hi_a - lo_a, min=EPS_WIDTH)
        hi_a = lo_a + w_a
        avg_a = torch.as_tensor([self.snippets[i].agg == AVG for i in a],
                                device=self.device)
        cnt_a = cat_a.to(F64).sum(-1).prod(-1)
        norm_a = torch.where(avg_a, w_a.prod(-1) * cnt_a,
                             torch.ones_like(cnt_a))
        if diag:
            ii = _se_integral(lo_a, hi_a, lo_a, hi_a).clamp(min=0.0)
            return ii.prod(-1) * cnt_a / (norm_a * norm_a)
        lo_b, hi_b, cat_b, _ = self._tensors(b)
        w_b = torch.clamp(hi_b - lo_b, min=EPS_WIDTH)
        hi_b = lo_b + w_b
        avg_b = torch.as_tensor([self.snippets[i].agg == AVG for i in b],
                                device=self.device)
        cnt_b = cat_b.to(F64).sum(-1).prod(-1)
        norm_b = torch.where(avg_b, w_b.prod(-1) * cnt_b,
                             torch.ones_like(cnt_b))
        ii = _se_integral(lo_a[:, None], hi_a[:, None], lo_b[None],
                          hi_b[None]).clamp(min=0.0).prod(-1)
        overlap = torch.einsum("ikv,jkv->ijk", cat_a.to(F64),
                               cat_b.to(F64)).prod(-1)
        return ii * overlap / (norm_a[:, None] * norm_b[None, :])

    def improve(self, new: Sequence[int], raw_t: np.ndarray,
                raw_b: np.ndarray, held: "Synopsis"):
        """Improved (theta, beta2) of snippets ``new`` from ``held``."""
        if not held.entries:
            return raw_t, raw_b
        ids = [e.sid for e in held.entries.values()]
        theta_h = torch.as_tensor([e.theta for e in held.entries.values()],
                                  dtype=F64, device=self.device)
        beta2_h = torch.as_tensor([e.beta2 for e in held.entries.values()],
                                  dtype=F64, device=self.device)
        sigma = self._cov(ids, ids)
        sigma.diagonal().copy_(self._cov(ids, None, diag=True) + beta2_h)
        sigma.diagonal().add_(NUGGET)
        k = self._cov(new, ids)  # (q, n)
        chol, bad = torch.linalg.cholesky_ex(sigma)
        if int(bad) == 0:
            alpha = torch.cholesky_solve(theta_h[:, None], chol)[:, 0]
            v = torch.linalg.solve_triangular(chol, k.T, upper=False)
            quad = (v * v).sum(0)
        else:  # rounding left it short of definite: LU with pivoting
            sol = torch.linalg.solve(sigma, torch.cat([theta_h[:, None],
                                                       k.T], 1))
            alpha, quad = sol[:, 0], (k.T * sol[:, 1:]).sum(0)
        prior = k @ alpha
        gamma2 = torch.clamp(self._cov(new, None, diag=True) - quad,
                             min=GAMMA_FLOOR)
        rt = torch.as_tensor(raw_t, dtype=F64, device=self.device)
        rb = torch.as_tensor(raw_b, dtype=F64, device=self.device)
        denom = rb + gamma2
        theta = (rb * prior + gamma2 * rt) / denom
        beta2 = rb * gamma2 / denom
        exact = rb <= 0.0
        theta = torch.where(exact, rt, theta)
        beta2 = torch.where(exact, torch.zeros_like(beta2), beta2)
        is_freq = torch.as_tensor([self.snippets[i].agg == FREQ for i in new],
                                  device=self.device)
        ok = ((rt - theta).abs() <= self.z_valid * torch.sqrt(rb.clamp(min=0))
              ) & (~is_freq | (theta >= 0.0))
        theta = torch.where(ok, theta, rt)
        beta2 = torch.where(ok, beta2, rb)
        return theta.cpu().numpy(), beta2.cpu().numpy()

    def assemble(self, dq: Decomposed, groups: Sequence[int], theta: dict,
                 beta2: dict) -> List[tuple]:
        """Cells (group, agg index, kind, estimate, beta2) of the groups
        ``groups`` (indices into ``dq.groups``), from snippet answers."""
        n = float(self.n_rows)
        out = []
        for g in groups:
            r = dq.rows[g]
            for ai, kind, m in dq.cells:
                f = r[(FREQ, 0)]
                if kind == "AVG":
                    a = r[(AVG, m)]
                    est, var = theta[a], beta2[a]
                elif kind == "COUNT":
                    est, var = theta[f] * n, beta2[f] * n * n
                else:
                    a = r[(AVG, m)]
                    est = theta[a] * theta[f] * n
                    var = (beta2[a] * (theta[f] * n) ** 2
                           + beta2[f] * (theta[a] * n) ** 2)
                out.append((dq.groups[g], ai, kind, float(est),
                            float(max(var, 0.0))))
        return out


def _antiderivative(u):
    """F(u) of the SE kernel at lengthscale 1: d^2F/dx dy = exp(-u^2)."""
    return -0.5 * torch.exp(-u * u) - 0.5 * SQRT_PI * u * torch.erf(u)


def _se_integral(a, b, c, d):
    """The double integral of exp(-(x - y)^2) over [a, b] x [c, d]."""
    f = _antiderivative
    return f(b - d) - f(b - c) - f(a - d) + f(a - c)


@dataclasses.dataclass
class Entry:
    sid: int
    theta: float
    beta2: float
    stamp: int


class Synopsis:
    """The past raw answers one aggregate key holds (paper section 2.3)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: Dict[int, Entry] = {}  # snippet id -> entry
        self.clock = 0

    def record(self, sids: Sequence[int], theta, beta2):
        pending: Dict[int, list] = {}
        for sid, t, b in zip(sids, theta, beta2):
            if not (np.isfinite(t) and np.isfinite(b)):
                continue
            self.clock += 1
            e = self.entries.get(sid)
            if e is not None:
                e.stamp = self.clock
                if b < e.beta2:
                    e.theta, e.beta2 = float(t), float(b)
                continue
            p = pending.get(sid)
            if p is None:
                pending[sid] = [float(t), float(b), self.clock]
            else:
                p[2] = self.clock
                if b < p[1]:
                    p[0], p[1] = float(t), float(b)
        new = list(pending.items())
        if len(new) > self.capacity:
            new = sorted(new, key=lambda kv: kv[1][2])[-self.capacity:]
        n_evict = max(0, len(self.entries) + len(new) - self.capacity)
        if n_evict:
            old = sorted(self.entries.values(), key=lambda e: e.stamp)
            for e in old[:n_evict]:
                del self.entries[e.sid]
        for sid, (t, b, stamp) in new:
            self.entries[sid] = Entry(sid, t, b, stamp)


@dataclasses.dataclass
class Judged:
    """What the program answered for one judged query: its cells
    ``(group, agg index, kind, estimate, beta2)`` and its raw snippet
    answers ``{(group, agg, measure): (theta, beta2)}``."""

    cells: List[tuple]
    raw: Dict[tuple, Tuple[float, float]]


def check(ref: AqpReference, history: Sequence[tuple],
          judged: Dict[int, Judged], target: float, n_batches: int) -> dict:
    """Replay ``history`` (``(spec, batches_used)`` in the engine's order)
    and judge the queries ``judged`` names (by history index).

    Returns the compared numbers and, under ``"info"``, what is reported
    beside them."""
    dqs = [ref.decompose(spec) for spec, _ in history]
    cum = ref.batch_partials(list(range(len(ref.snippets)))).cpu().numpy()
    aggs = [s.agg for s in ref.snippets]
    synopses: Dict[tuple, Synopsis] = {}
    numbers = {"groups_bad": 0, "answer_gap": 0.0, "bound_ratio": 0.0}
    stop_ratio = 0.0
    judged_cells = []  # (history index, group, agg index, program cell)
    for h, ((spec, used), dq) in enumerate(zip(history, dqs)):
        present, need, raw_t, raw_b = _raw(ref, dq, spec, used, cum, aggs,
                                           n_batches)
        if not present:
            if h in judged and judged[h].cells:
                numbers["groups_bad"] += 1
            continue
        sids = list(raw_t)
        by_key: Dict[tuple, List[int]] = {}
        for sid in sids:
            by_key.setdefault(ref.snippets[sid].synopsis, []).append(sid)
        if h in judged:
            worst = _judge(ref, dq, present, need, raw_t, raw_b, by_key,
                           synopses, judged[h], numbers)
            if worst is not None:
                judged_cells.extend((h, tuple(c[0]), c[1], c)
                                    for c in judged[h].cells)
                if int(used) < n_batches:
                    stop_ratio = max(stop_ratio, worst / target)
        for key, ks in by_key.items() if ref.learning else ():
            synopses.setdefault(key, Synopsis(ref.capacity)).record(
                ks, [raw_t[i] for i in ks], [raw_b[i] for i in ks])
    numbers["info"] = _exact_info(ref, dqs, judged_cells)
    numbers["info"]["stop_ratio_ref"] = stop_ratio
    numbers["info"]["judged_queries"] = len(judged)
    numbers["info"]["judged_cells"] = len(judged_cells)
    return numbers


def _raw(ref, dq, spec, used, cum, aggs, n_batches):
    """A query's present groups (indices into ``dq.groups``), the snippet
    keys its cells need, and its raw answers ``{snippet id: theta}``,
    ``{snippet id: beta2}`` after ``used`` batches. Group-by values are
    those with a tuple in the first batch, at most ``n_max`` of them."""
    present = ([g for g, r in enumerate(dq.rows)
                if cum[0, r[(FREQ, 0)], 0] > 0][:ref.n_max]
               if spec.groupby else [0])
    need = _needed(dq)
    sids = list(dict.fromkeys(sid for g in present
                              for k, sid in dq.rows[g].items() if k in need))
    if not present:
        return present, need, {}, {}
    b = min(max(int(used), 1), n_batches) - 1
    theta, beta2 = ref.estimates(cum[b, sids], [aggs[i] for i in sids],
                                 ref.scanned(b + 1))
    return present, need, dict(zip(sids, theta)), dict(zip(sids, beta2))


def raw_answers(ref: AqpReference, history: Sequence[tuple],
                picks, n_batches: int) -> Dict[int, Judged]:
    """What an engine without learning answers for the queries ``picks``
    (history indices) of ``history``, in ``ref``'s precision: each one's
    cells and raw snippet answers, as ``Judged`` keys them."""
    dqs = {h: ref.decompose(history[h][0]) for h in sorted(picks)}
    cum = ref.batch_partials(list(range(len(ref.snippets)))).cpu().numpy()
    aggs = [s.agg for s in ref.snippets]
    out = {}
    for h, dq in dqs.items():
        spec, used = history[h]
        present, need, raw_t, raw_b = _raw(ref, dq, spec, used, cum, aggs,
                                           n_batches)
        raw = {(dq.groups[g], agg, m): (float(raw_t[sid]), float(raw_b[sid]))
               for g in present for (agg, m), sid in dq.rows[g].items()
               if (agg, m) in need}
        out[h] = Judged(ref.assemble(dq, present, raw_t, raw_b), raw)
    return out


def _judge(ref, dq, present, need, raw_t, raw_b, by_key, synopses, jt,
           numbers):
    """Compare one judged query's answers with the reference's.

    ``groups_bad`` counts queries whose groups or cells differ;
    ``answer_gap`` is the largest gap of a raw snippet answer or an
    improved cell (estimate, or the square root of its variance) in units
    of the reference's raw standard error of that snippet or cell;
    ``bound_ratio`` the largest ratio of the reference's improved standard
    error to the program's: how far the program understates its bound.
    Returns the largest relative error bound of the reference's cells (None
    where the groups differ, so nothing else compares)."""
    want_groups = sorted(dq.groups[g] for g in present)
    got_groups = sorted({tuple(c[0]) for c in jt.cells})
    if (want_groups != got_groups
            or len(jt.cells) != len(present) * len(dq.cells)):
        numbers["groups_bad"] += 1
        return None
    for g in present:
        for (agg, m), sid in dq.rows[g].items():
            if (agg, m) not in need:
                continue
            got = jt.raw.get((dq.groups[g], agg, m))
            if got is None:
                numbers["groups_bad"] += 1
                return None
            scale = math.sqrt(raw_b[sid])
            gap = max(abs(got[0] - raw_t[sid]),
                      abs(math.sqrt(max(got[1], 0.0)) - scale))
            numbers["answer_gap"] = max(numbers["answer_gap"],
                                        _ratio(gap, scale))
    imp_t, imp_b = dict(raw_t), dict(raw_b)
    for key, ks in by_key.items():
        syn = synopses.get(key)
        if syn is None:
            continue
        t, v = ref.improve(ks, np.asarray([raw_t[i] for i in ks]),
                           np.asarray([raw_b[i] for i in ks]), syn)
        imp_t.update(zip(ks, t))
        imp_b.update(zip(ks, v))
    want = ref.assemble(dq, present, imp_t, imp_b)
    raw_cells = ref.assemble(dq, present, raw_t, raw_b)
    got = {(tuple(c[0]), c[1]): c for c in jt.cells}
    worst = 0.0
    for w, r in zip(want, raw_cells):
        c = got[(w[0], w[1])]
        gap = max(abs(c[3] - w[3]), abs(math.sqrt(c[4]) - math.sqrt(w[4])))
        numbers["answer_gap"] = max(numbers["answer_gap"],
                                    _ratio(gap, math.sqrt(r[4])))
        numbers["bound_ratio"] = max(numbers["bound_ratio"],
                                     _ratio(math.sqrt(w[4]),
                                            math.sqrt(c[4])))
        worst = max(worst, ref.z_report * math.sqrt(w[4])
                    / max(abs(w[3]), 1e-9))
    return worst


def _needed(dq: Decomposed):
    need = set()
    for _, kind, m in dq.cells:
        if kind in ("AVG", "SUM") and m is not None:
            need.add((AVG, m))
        if kind in ("SUM", "COUNT"):
            need.add((FREQ, 0))
    return need


def _ratio(gap: float, scale: float) -> float:
    """``gap`` in units of ``scale`` (a finite number, for the JSON line)."""
    return min(gap / max(scale, 1e-300), 1e300) if gap else 0.0


def _exact_info(ref: AqpReference, dqs, judged_cells) -> dict:
    """Coverage of the judged cells' 95% intervals over the exact answers,
    and their median relative error (reported, not compared)."""
    if not judged_cells:
        return {"coverage": None, "median_rel_error": None}
    need = sorted({sid for h, *_ in judged_cells
                   for r in dqs[h].rows for sid in r.values()})
    exact = ref.partials(need, None).cpu().numpy()
    pos = {sid: i for i, sid in enumerate(need)}
    covered, errs = 0, []
    for h, group, ai, c in judged_cells:
        dq = dqs[h]
        g = dq.groups.index(group)
        _, kind, m = dq.cells[ai]
        f = exact[pos[dq.rows[g][(FREQ, 0)]]]
        if kind == "COUNT":
            truth = f[0]
        elif kind == "AVG":
            a = exact[pos[dq.rows[g][(AVG, m)]]]
            truth = a[1] / max(a[0], 1.0)
        else:
            a = exact[pos[dq.rows[g][(AVG, m)]]]
            truth = a[1]
        err = abs(c[3] - truth)
        covered += err <= ref.z_report * math.sqrt(c[4])
        errs.append(err / max(abs(truth), 1e-9))
    return {"coverage": covered / len(judged_cells),
            "median_rel_error": float(np.median(errs))}
