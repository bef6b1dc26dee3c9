"""The port's main path end to end against the JAX reference engine (CPU).

- data: ``make_relation`` / ``tpch_like`` / ``build_sample`` give exactly
  the reference's arrays (both draw with numpy ``default_rng``);
- ``execute`` and ``execute_many`` answer like the reference engine for both
  ``use_kernels`` values: equal ``batches_used`` and ``accepted``, cells at
  rtol 1e-9 (float64) or at the reference's own 1e-3 engine-level budget
  for the float32 improve kernel (``use_kernels=True``);
- a reference ``synopses_state_dict()`` loads into the port as it is and
  both packages then improve new snippets alike;
- inside the port: ``execute(q) == execute_many([q])[0]`` and async ingest
  equals sync ingest, bitwise;
- the device rule: no CUDA device means the default device fails loudly;
- the package imports neither ``jax`` nor ``repro``;
- both engines' 95% intervals cover the same cells of the exact answers
  (``coverage_study``; as a script this file runs that study at any size,
  e.g. the main path's recipe cut from TPC-H SF1 to a tenth, with
  ``--refit STEPS`` refitting both engines between warm-up and serving:

      PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_engine.py \\
          --rows 600000 --warm 2000 --serve 200 [--refit 150]
  ).
"""
import argparse
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.aqp import sampler as jx_sampler  # noqa: E402
from repro.aqp import workload as jx_w  # noqa: E402
from repro.core import engine as jx_engine  # noqa: E402
from repro.core import types as jx_types  # noqa: E402
from repro_torch.aqp import queries as Q  # noqa: E402
from repro_torch.aqp import sampler as pt_sampler  # noqa: E402
from repro_torch.aqp import workload as pt_w  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import types as pt_types  # noqa: E402
from repro_torch.utils.stats import confidence_multiplier  # noqa: E402

REL_KW = dict(seed=5, n_rows=6000, n_num=2, cat_sizes=(4,), n_measures=1)
CFG_KW = dict(sample_rate=0.2, n_batches=3, seed=1, capacity=24)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_relations_and_samples_equal_reference_exactly():
    pairs = [(jx_w.make_relation(**REL_KW),
              pt_w.make_relation(**REL_KW, device="cpu")),
             (jx_w.tpch_like(3, n_rows=5000),
              pt_w.tpch_like(3, n_rows=5000, device="cpu"))]
    for jr, pr in pairs:
        assert repr(jr.schema) == repr(pr.schema)
        for f in ("num", "cat", "measures", "num_normalized"):
            np.testing.assert_array_equal(_np(getattr(pr, f)),
                                          _np(getattr(jr, f)), err_msg=f)
        js = jx_sampler.build_sample(jr, rate=0.1, n_batches=4, seed=2)
        ps = pt_sampler.build_sample(pr, rate=0.1, n_batches=4, seed=2)
        assert len(js.batch_rows) == len(ps.batch_rows)
        for a, b in zip(js.batch_rows, ps.batch_rows):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(_np(ps.relation.num_normalized),
                                      _np(js.relation.num_normalized))
    assert (repr(pt_w.tpch_workload(4, pairs[1][1].schema, 30))
            == repr(jx_w.tpch_workload(4, pairs[1][0].schema, 30)))


def _engines(use_kernels):
    cfg = dict(CFG_KW, use_kernels=use_kernels)
    jr = jx_w.make_relation(**REL_KW)
    pr = pt_w.make_relation(**REL_KW, device="cpu")
    return (jx_engine.VerdictEngine(jr, jx_engine.EngineConfig(**cfg)),
            pt_engine.VerdictEngine(pr, pt_engine.EngineConfig(**cfg),
                                    device="cpu"))


def _workload(n=10, seed=6):
    """AVG/COUNT/SUM queries, plus a group-by and an unsupported one."""
    sch = pt_w.make_relation(**REL_KW, device="cpu").schema
    qs = pt_w.make_workload(seed, sch, n, agg_kinds=("AVG", "COUNT", "SUM"))
    qs.append(Q.AggQuery(aggs=(Q.AggSpec("AVG", 0), Q.AggSpec("COUNT")),
                         predicates=(Q.NumRange(0, 2.0, 7.0),), groupby=(0,)))
    qs.append(Q.AggQuery(aggs=(Q.AggSpec("MAX", 0),),
                         predicates=(Q.NumRange(1, 1.0, 6.0),)))
    return qs


def _to_reference_query(q):
    """The same query built from the reference's own dataclasses."""
    from repro.aqp import queries as JQ

    conv = {"NumRange": JQ.NumRange, "NumEq": JQ.NumEq, "CatEq": JQ.CatEq,
            "CatIn": JQ.CatIn}
    preds = tuple(conv[type(p).__name__](**vars(p)) for p in q.predicates)
    aggs = tuple(JQ.AggSpec(a.kind, a.measure) for a in q.aggs)
    return JQ.AggQuery(aggs=aggs, predicates=preds, groupby=q.groupby)


def _assert_same_answers(got, want, rtol):
    assert got.batches_used == want.batches_used
    assert got.supported == want.supported
    assert len(got.cells) == len(want.cells)
    for c, w in zip(got.cells, want.cells):
        assert c["group"] == w["group"] and c["kind"] == w["kind"]
        np.testing.assert_allclose(c["estimate"], w["estimate"], rtol=rtol)
        np.testing.assert_allclose(c["beta2"], w["beta2"], rtol=rtol,
                                   atol=1e-300)
    if want.snippet_answer is not None:
        np.testing.assert_array_equal(_np(got.snippet_answer.accepted),
                                      np.asarray(want.snippet_answer.accepted))


@pytest.mark.parametrize("use_kernels,rtol", [(False, 1e-9), (True, 1e-3)])
def test_execute_and_execute_many_match_reference(use_kernels, rtol):
    qs = _workload()
    jqs = [_to_reference_query(q) for q in qs]
    jeng, peng = _engines(use_kernels)
    # execute_many warms both synopses, then queries one by one to a target.
    for got, want in zip(peng.execute_many(qs[:6]), jeng.execute_many(jqs[:6])):
        _assert_same_answers(got, want, rtol)
    accepted_any = False
    for q, jq in zip(qs[6:], jqs[6:]):
        got = peng.execute(q, target_rel_error=0.05)
        want = jeng.execute(jq, target_rel_error=0.05)
        _assert_same_answers(got, want, rtol)
        if want.snippet_answer is not None:
            accepted_any |= bool(np.asarray(want.snippet_answer.accepted).any())
    assert accepted_any  # the improve path, not only raw answers, was held


def test_reference_state_dict_loads_into_the_port():
    """Carrying learned state across: a JAX engine's synopses_state_dict()
    loads as it is; both packages then improve new snippets alike."""
    from repro_torch.core.types import RawAnswer

    qs = _workload(n=14, seed=8)
    jeng, peng = _engines(False)
    jeng.execute_many([_to_reference_query(q) for q in qs])
    peng.load_synopses_state_dict(jeng.synopses_state_dict())
    rng = np.random.default_rng(0)
    kw = dict(agg=0, measure=0, num_ranges=[
        {0: (a, a + 3.0)} for a in rng.uniform(0, 6, 5)])
    jsn = jx_types.make_snippets(jeng.schema, **kw)
    psn = pt_types.make_snippets(peng.schema, **kw)
    raw = rng.normal(10.0, 0.5, 5)
    want = jeng.synopsis_for(0, 0).improve(
        jsn, jx_types.RawAnswer(jnp.asarray(raw), jnp.full(5, 0.05)))
    got = peng.synopsis_for(0, 0).improve(
        psn, RawAnswer(torch.as_tensor(raw), torch.full((5,), 0.05,
                                                        dtype=torch.float64)))
    assert peng.synopsis_for(0, 0).n == jeng.synopsis_for(0, 0).n > 0
    np.testing.assert_array_equal(_np(got.accepted), np.asarray(want.accepted))
    np.testing.assert_allclose(_np(got.theta), np.asarray(want.theta),
                               rtol=1e-9)
    np.testing.assert_allclose(_np(got.beta2), np.asarray(want.beta2),
                               rtol=1e-9)
    sd = peng.synopses_state_dict()
    assert set(sd) == set(jeng.synopses_state_dict())


def test_execute_equals_execute_many_of_one_and_async_equals_sync():
    """Inside the port, bitwise: one query is a workload of one, and the
    background ingest thread changes nothing."""
    qs = _workload(n=8, seed=9)
    pr = pt_w.make_relation(**REL_KW, device="cpu")
    engines = [pt_engine.VerdictEngine(
        pr, pt_engine.EngineConfig(**CFG_KW, async_ingest=a), device="cpu")
        for a in (True, True, False)]
    for q in qs:
        outs = [engines[0].execute(q, target_rel_error=0.05),
                engines[1].execute_many([q], target_rel_error=0.05)[0],
                engines[2].execute(q, target_rel_error=0.05)]
        for o in outs[1:]:
            assert o.batches_used == outs[0].batches_used
            assert o.cells == outs[0].cells


def test_default_device_is_cuda_and_fails_loudly_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_w.make_relation(**REL_KW)
    pr = pt_w.make_relation(**REL_KW, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_engine.VerdictEngine(pr)


def test_engine_rejects_a_relation_on_another_device():
    pr = pt_w.make_relation(**REL_KW, device="cpu")
    with pytest.raises(ValueError, match="relation lives on"):
        pt_engine.VerdictEngine(pr, device="meta")


def test_package_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.aqp.batch, repro_torch.kernels, "
            "repro_torch.serving.engine, repro_torch.models.transformer, "
            "repro_torch.configs, repro_torch.training, "
            "repro_torch.launch.train, repro_torch.launch.roofline, "
            "repro_torch.data.pipeline;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    import os

    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _cell_keys(plan):
    """The synopsis names (``state_key``) each cell of ``plan`` reads: AVG
    its measure's AVG synopsis, COUNT the FREQ synopsis, SUM both."""
    from repro_torch.core.store import agg_key, state_key
    from repro_torch.core.types import AVG, FREQ

    agg, mea = _np(plan.snippets.agg), _np(plan.snippets.measure)
    keys = []
    for _, _, kind, avg_row, freq_row in plan.cells:
        names = []
        if kind in ("AVG", "SUM"):
            names.append(state_key(agg_key(AVG, mea[avg_row])))
        if kind in ("COUNT", "SUM"):
            names.append(state_key(agg_key(FREQ, 0)))
        keys.append(tuple(names))
    return keys


def count_inverse_rebuilds():
    """Count, per synopsis name, the appends whose blocked inverse update
    lost definiteness: the port's ``inv_append_block`` returned None and
    the port rebuilt Sigma^-1 by Cholesky (``port``); the reference's Schur
    complement had an eigenvalue <= 0, which it clamps to the jitter
    (``jax_clamped``), and the appends after which the reference's inverse
    held a non-finite value (``jax_nonfinite``). Patches both synopsis
    modules for the rest of the process; returns the live counters."""
    import collections
    import threading

    from repro.core import synopsis as jx_syn
    from repro_torch.core import synopsis as pt_syn

    counts = {k: collections.Counter()
              for k in ("port", "jax_clamped", "jax_nonfinite")}
    local = threading.local()

    def insert(orig):
        def run(self, rows):
            local.name = self.name
            return orig(self, rows)
        return run

    pt_append, jx_append = pt_syn.inv_append_block, jx_syn.inv_append_block

    def port_append(ainv, cols, block, jitter=pt_syn.JITTER):
        out = pt_append(ainv, cols, block, jitter)
        if out is None:
            counts["port"][local.name] += 1
        return out

    def jax_append(ainv, cols, block, jitter=jx_syn.JITTER):
        a, c, b = (np.asarray(v) for v in (ainv, cols, block))
        s = b - (c @ a) @ c.T
        if np.linalg.eigvalsh(0.5 * (s + s.T)).min() <= 0.0:
            counts["jax_clamped"][local.name] += 1
        out = jx_append(ainv, cols, block, jitter)
        if not np.isfinite(np.asarray(out)).all():
            counts["jax_nonfinite"][local.name] += 1
        return out

    for mod, fn in ((pt_syn, port_append), (jx_syn, jax_append)):
        mod.Synopsis._insert_block_into_model = insert(
            mod.Synopsis._insert_block_into_model)
        mod.inv_append_block = fn
    return counts


def _digest(*arrays):
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _sketch(sinv):
    """(Sigma^-1 r, its diagonal) for a fixed random r: an O(n) record of
    an (n, n) inverse that moves with every entry of it."""
    a = np.asarray(sinv, np.float64)
    r = np.random.default_rng(12345).uniform(-1.0, 1.0, a.shape[0])
    return np.concatenate([a @ r, np.diag(a)])


def _rel_diff(a, b):
    """max |a - b| / max |b| (norm-wise), inf where the shapes differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def trace_applies():
    """Record, for both packages and per synopsis name, every ingest
    (``Synopsis._apply_add``) in order: a digest of its arguments and of
    the model state it starts from (Sigma in the inverse's order,
    Sigma^-1, alpha, the GP parameters), every step inside it (the
    covariance blocks it builds, each blocked append and delete of the
    inverse, each full refactor) with a digest and the values (the blocks
    in full, an inverse as ``_sketch``), and after it Sigma^-1 (digest and
    sketch) and alpha (in full). Patches both synopsis modules for the
    rest of the process; returns ``{"jax": {name: [record]}, "port":
    ...}``. ``apply_divergence`` reads it."""
    import threading

    from repro.core import synopsis as jx_syn
    from repro_torch.core import synopsis as pt_syn

    traces = {"jax": {}, "port": {}}
    local = threading.local()

    def state(self):
        order = np.asarray(self._order, np.int64)
        p = self.params
        return _digest(self._sigma[np.ix_(order, order)], self._sigma_inv,
                       self._alpha, order,
                       *(np.asarray(getattr(p, f))
                         for f in ("log_ls", "log_sigma2", "mu")))

    def apply(pkg, orig):
        def run(self, *args):
            rec = {"args": _digest(*args), "before": state(self),
                   "steps": []}
            local.rec = rec
            try:
                return orig(self, *args)
            finally:
                local.rec = None
                rec["after"] = _digest(self._sigma_inv, self._alpha)
                rec["sinv"] = _sketch(self._sigma_inv)
                rec["alpha"] = np.array(np.asarray(self._alpha))
                rec["n"] = len(self._order)
                traces[pkg].setdefault(self.name, []).append(rec)
        return run

    def step(kind, orig, values):
        def run(*args, **kw):
            out = orig(*args, **kw)
            rec = getattr(local, "rec", None)
            if rec is not None:
                vals = values(args, out)
                rec["steps"].append((kind, _digest(*vals), vals))
            return out
        return run

    def blocks(args, out):
        return [np.array(v) for v in out]

    def inverse(args, out):
        return [] if out is None else [_sketch(out)]

    def refactored(args, out):
        return [_sketch(args[0]._sigma_inv)]

    for pkg, mod in (("jax", jx_syn), ("port", pt_syn)):
        cls = mod.Synopsis
        cls._apply_add = apply(pkg, cls._apply_add)
        cls._cov_blocks = step("covariance blocks", cls._cov_blocks, blocks)
        cls._refactor = step("refactor", cls._refactor, refactored)
        mod.inv_append_block = step("append", mod.inv_append_block, inverse)
        mod.inv_delete_block = step("delete", mod.inv_delete_block, inverse)
    return traces


def apply_divergence(traces, rtol=1e-12):
    """Per synopsis name, where the two packages' ingests part: the first
    apply whose state after it is not bitwise equal, and the first whose
    Sigma^-1 sketch or alpha differs by more than ``rtol`` (norm-wise);
    for each, whether its arguments and starting state were bitwise equal,
    and its first step whose output differs (kind, relative difference)."""
    out = {}
    for name in sorted(set(traces["jax"]) | set(traces["port"])):
        js, ps = traces["jax"].get(name, []), traces["port"].get(name, [])
        info = {"applies": (len(js), len(ps)), "first_unequal": None,
                "first_beyond": None}
        for i, (j, p) in enumerate(zip(js, ps)):
            rel = max(_rel_diff(p["sinv"], j["sinv"]),
                      _rel_diff(p["alpha"], j["alpha"]))
            if info["first_unequal"] is None and j["after"] != p["after"]:
                info["first_unequal"] = _apply_summary(i, j, p, rel)
            if rel > rtol:
                info["first_beyond"] = _apply_summary(i, j, p, rel)
                break
        out[name] = info
    return out


def _apply_summary(i, j, p, rel):
    step = None
    for (kj, dj, vj), (kp, dp, vp) in zip(j["steps"], p["steps"]):
        if kj != kp:
            step = (f"{kj} / {kp} (another sequence of steps)", None)
            break
        if dj != dp:
            step = (kj, max(_rel_diff(a, b) for a, b in zip(vp, vj))
                    if len(vj) == len(vp) and vj else float("inf"))
            break
    if step is None and len(j["steps"]) != len(p["steps"]):
        step = ("step count", None)
    return {"apply": i, "n": (j["n"], p["n"]), "rel": rel,
            "args_equal": j["args"] == p["args"],
            "state_equal": j["before"] == p["before"], "step": step}


def library_last_bits(n=200_000, seed=0):
    """How often XLA's and PyTorch's CPU exp and erf (the transcendentals of
    the SE integral, Appendix F.1) differ on the same float64 arguments
    u / z, u uniform in [-1, 1], z = 0.7: {name: (count, largest relative
    difference)}."""
    from jax.scipy.special import erf as jx_erf

    u = np.random.default_rng(seed).uniform(-1.0, 1.0, n) / 0.7
    out = {}
    for name, jf, pf in (
            ("exp", lambda v: jnp.exp(-v * v), lambda v: torch.exp(-v * v)),
            ("erf", jx_erf, torch.special.erf)):
        a = np.asarray(jf(jnp.asarray(u)))
        b = pf(torch.as_tensor(u)).numpy()
        out[name] = (int((a != b).sum()), float(
            (np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max()))
    return out


def coverage_study(jeng, peng, warm, serve, log=None, refit_steps=None):
    """Warm both engines up with ``execute_many(warm)``, ``refit`` them
    (``refit_steps`` Adam steps; None: no refit), then serve ``serve`` one
    by one at a 2% target (the port's queries; the reference gets the same
    ones). Returns, per engine, the cells' coverage flags and estimates,
    plus the queries whose ``batches_used`` differ."""
    results = {}
    for name, eng, conv in (("jax", jeng, _to_reference_query),
                            ("port", peng, lambda q: q)):
        t0 = time.perf_counter()
        eng.execute_many([conv(q) for q in warm])
        if refit_steps:
            eng.refit(steps=refit_steps)
        results[name] = [eng.execute(conv(q), target_rel_error=0.02)
                         for q in serve]
        eng.drain()
        if log:
            log(f"{name}: {len(warm)} warm-up + {len(serve)} served queries "
                f"in {time.perf_counter() - t0:.1f} s")
    rel = peng.relation
    alpha = float(confidence_multiplier(0.95))
    out = {name: {"covered": [], "estimate": []} for name in results}
    out["port"]["keys"] = []  # the synopses each of the port's cells reads
    differ = []
    for i, (rj, rp) in enumerate(zip(results["jax"], results["port"])):
        if rj.batches_used != rp.batches_used:
            differ.append(i)
        if rp.plan is None:  # no cells: unsupported, or no groups found
            assert not rj.cells
            continue
        exact = rel.exact_answer(rp.plan.snippets)
        truth = Q.assemble_results(rp.plan, exact, torch.zeros_like(exact),
                                   rel.cardinality)
        out["port"]["keys"].extend(_cell_keys(rp.plan))
        for name, r in (("jax", rj), ("port", rp)):
            assert [(c["group"], c["kind"]) for c in r.cells] == [
                (e["group"], e["kind"]) for e in truth]
            for c, e in zip(r.cells, truth):
                err = abs(c["estimate"] - e["estimate"])
                out[name]["covered"].append(
                    bool(err <= alpha * np.sqrt(c["beta2"])))
                out[name]["estimate"].append(c["estimate"])
    return out, differ


def test_port_and_reference_cover_the_same_cells():
    """Same decisions, the same coverage verdict on every cell, estimates
    at rtol 1e-9."""
    jeng, peng = _engines(False)
    qs = _workload(n=12, seed=10)
    out, differ = coverage_study(jeng, peng, qs[:6], qs[6:])
    assert not differ
    assert out["port"]["covered"] == out["jax"]["covered"]
    np.testing.assert_allclose(out["port"]["estimate"],
                               out["jax"]["estimate"], rtol=1e-9)
    assert len(out["port"]["covered"]) > 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=600_000)
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--serve", type=int, default=200)
    ap.add_argument("--capacity", type=int, default=2000)
    ap.add_argument("--refit", type=int, default=0,
                    help="refit both engines with this many Adam steps "
                         "between the warm-up and the served queries")
    args = ap.parse_args()
    cfg = dict(sample_rate=0.1, n_batches=10, capacity=args.capacity,
               seed=args.seed)
    peng = pt_engine.VerdictEngine(
        pt_w.tpch_like(args.seed, n_rows=args.rows, device="cpu"),
        pt_engine.EngineConfig(**cfg), device="cpu")
    jeng = jx_engine.VerdictEngine(jx_w.tpch_like(args.seed, n_rows=args.rows),
                                   jx_engine.EngineConfig(**cfg))
    for name, (count, rel) in library_last_bits().items():
        print(f"{name} of 200,000 float64 arguments: XLA and PyTorch differ "
              f"on {count}, by at most {rel:.3e} relative")
    rebuilds = count_inverse_rebuilds()
    traces = trace_applies()
    out, differ = coverage_study(
        jeng, peng, pt_w.tpch_workload(args.seed, peng.schema, args.warm),
        pt_w.tpch_workload(args.seed + 1, peng.schema, args.serve),
        log=lambda s: print(s, flush=True), refit_steps=args.refit)
    for name, o in out.items():
        cov = o["covered"]
        print(f"{name}: 95% intervals cover {sum(cov)}/{len(cov)} cells "
              f"({sum(cov) / max(len(cov), 1):.4f})")
    same = sum(a == b for a, b in zip(out["jax"]["covered"],
                                      out["port"]["covered"]))
    est_j, est_p = (np.asarray(out[n]["estimate"]) for n in ("jax", "port"))
    rel = np.abs(est_p - est_j) / np.maximum(np.abs(est_j), 1e-300)
    print(f"same coverage verdict on {same}/{len(est_j)} cells; queries with "
          f"different batches_used: {differ}; largest relative difference "
          f"of estimates {rel.max() if rel.size else 0.0:.3e}")
    # Where the estimates part: per synopsis, the inverse rebuilds and the
    # largest relative difference of the cells that read it.
    keys = out["port"]["keys"]
    for what, c in rebuilds.items():
        print(f"{what} rebuilds/clamps per synopsis: {dict(sorted(c.items()))}")
    names = sorted({k for ks in keys for k in ks})
    for name in names:
        on = np.array([name in ks for ks in keys])
        print(f"cells reading {name}: {int(on.sum())}, largest relative "
              f"difference {rel[on].max() if on.any() else 0.0:.3e}, "
              f"port rebuilds {rebuilds['port'][name]}, reference clamps "
              f"{rebuilds['jax_clamped'][name]}, non-finite reference "
              f"inverses {rebuilds['jax_nonfinite'][name]}")
    clean = np.array([not any(rebuilds["port"][k] for k in ks) for ks in keys])
    for label, sel in (("no rebuilt synopsis", clean),
                       ("a rebuilt synopsis", ~clean)):
        print(f"cells reading {label}: {int(sel.sum())}, largest relative "
              f"difference {rel[sel].max() if sel.any() else 0.0:.3e}")
    # Where the ingests part: per synopsis, the first apply not bitwise
    # equal and the first beyond 1e-12 (Sigma^-1 sketch or alpha).
    for name, info in apply_divergence(traces).items():
        print(f"ingests of {name}: {info['applies']} applies (jax, port); "
              f"first not bitwise equal {info['first_unequal']}; first "
              f"beyond 1e-12 relative {info['first_beyond']}")


if __name__ == "__main__":
    main()
