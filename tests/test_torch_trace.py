"""The port's static checker, trace layer (``repro_torch.analysis.programs``
and ``trace_rules``: rules T001-T007 over recorded runs of the scan plane's
programs) against the JAX reference's ``repro.analysis`` (CPU).

The reference reads jaxprs and StableHLO; the port records aten ops under a
``TorchDispatchMode``. Where the reference still runs on the installed JAX
(its program table, and its StableHLO and jit-cache rules T003, T004, T005
and T007), both packages run on the same cases and must agree: the same
program names, tags and shapes, no finding on the real tree, and the plain
scan under the ``fused`` tag flagged by both. The reference's jaxpr rules
(T001, T002, T006) fail on the installed JAX (``jax.core.ClosedJaxpr`` is
gone), so the port mirrors ``tests/test_analysis.py``'s fixtures for them
with fixtures of its own, written in torch: the reverted untiled fold, a
program with no fold, a descending and a tree fold, an f32 round trip and
an f32 output. The T003/T004 fixture sums the shards of a mask build
across shards (the eager counterpart of the reference's stray ``psum``);
the T007 fixtures are a dispatcher that leaks the unpadded Q into
``gp_batch_infer``'s launch and one that pads it.

The reference's T007 "unhashable static argument" case has no counterpart:
an eager call has no static arguments and no compile cache to key, so
nothing can be unhashable there.

Every port call passes ``device="cpu"``: on the CPU the kernel wrappers run
their plain versions, so the fused program's T005 is an ``info`` (the rule
gates on the card, where ``chip_smoke.py`` phase 12 and the ``gpu`` tests
run it).
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import programs as jx_programs  # noqa: E402
from repro.analysis import trace_rules as jx_rules  # noqa: E402
from repro.aqp import executor as jx_executor  # noqa: E402
from repro_torch.analysis import ast_rules as pt_ast  # noqa: E402
from repro_torch.analysis import programs as pt_programs  # noqa: E402
from repro_torch.analysis import trace_rules as pt_rules  # noqa: E402
from repro_torch.analysis.cli import main, run_repo_analysis  # noqa: E402
from repro_torch.analysis.findings import (ERROR, INFO, WARN,  # noqa: E402
                                           gate_count, render_text)
from repro_torch.aqp import executor  # noqa: E402
from repro_torch.kernels import SCAN_TILE_Q, SCAN_TILE_T  # noqa: E402

CPU = torch.device("cpu")
REP_T, REP_Q, REP_M = pt_programs.REP_T, pt_programs.REP_Q, pt_programs.REP_M


def _rules(findings):
    return {f.rule for f in findings}


def _records(findings):
    return [(f.rule, f.severity, f.location) for f in findings]


def _mask_payload(seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(REP_T, REP_Q)) < 0.3).astype(np.float64)
    payload = rng.normal(size=(REP_T, 2 * REP_M + 1))
    return torch.as_tensor(mask), torch.as_tensor(payload)


def _program(name, fn, args, tags, **kw):
    return pt_programs.Program(name, fn, args, frozenset(tags), device=CPU,
                               **kw)


@pytest.fixture(scope="module")
def pt_progs():
    return {p.name: p for p in pt_programs.engine_programs(device="cpu")}


@pytest.fixture(scope="module")
def jx_progs():
    return {p.name: p for p in jx_programs.engine_programs()}


# ------------------------------------------------------- the program table


def test_program_table_equals_the_reference(pt_progs, jx_progs):
    assert list(pt_progs) == list(jx_progs)
    for name, p in pt_progs.items():
        j = jx_progs[name]
        assert (p.tags, p.t, p.q) == (j.tags, j.t, j.q), name
    assert pt_progs["sharded_mask_build"].t == 2048
    names = {tag: [p.name for p in progs] for tag, progs in
             pt_programs.by_tag(list(pt_progs.values())).items()}
    assert names == {tag: [p.name for p in progs] for tag, progs in
                     jx_programs.by_tag(list(jx_progs.values())).items()}
    assert (pt_programs.REP_T, pt_programs.REP_Q, pt_programs.REP_L,
            pt_programs.REP_C, pt_programs.REP_V, pt_programs.REP_M,
            pt_programs.PSUM_BOUND) == (
        jx_programs.REP_T, jx_programs.REP_Q, jx_programs.REP_L,
        jx_programs.REP_C, jx_programs.REP_V, jx_programs.REP_M,
        jx_programs.PSUM_BOUND)


def test_every_program_runs_on_its_device(pt_progs):
    for p in pt_progs.values():
        trace = p.trace()
        assert trace.records, p.name
        assert all(o.device == "cpu" for r in trace.records
                   for o in r.outputs), p.name
        assert trace.peak_bytes is None  # a device number only on the card
    # the mask build's shard slices were labelled: 8 shards x (num, cat,
    # valid)
    shards = pt_progs["sharded_mask_build"].trace().shards
    assert sorted(set(shards.values())) == list(range(8))
    assert len(shards) == 24


# ------------------------------------------- the reference's verdicts


@pytest.mark.parametrize("rule,tag", [("T003", "mask-build"),
                                      ("T004", "agg")])
def test_shard_rules_agree_with_the_reference(rule, tag, pt_progs,
                                              jx_progs):
    check = {"T003": "check_mask_build_collectives",
             "T004": "check_agg_collectives"}[rule]
    names = [n for n, p in jx_progs.items() if tag in p.tags]
    assert names
    for name in names:
        want = getattr(jx_rules, check)(jx_progs[name])
        got = getattr(pt_rules, check)(pt_progs[name])
        assert _records(got) == _records(want) == [], name


def test_improve_ladder_agrees_with_the_reference():
    want = jx_rules.check_improve_cache_cardinality()
    got = pt_rules.check_improve_cache_cardinality(device="cpu")
    assert _records(got) == _records(want) == []
    want = jx_rules.check_scan_jit_cache()
    got = pt_rules.check_scan_launch_cache(device="cpu")
    assert _records(got) == _records(want) == []


def test_t005_plain_scan_as_fused_is_flagged_by_both(pt_progs, jx_progs):
    num, cat, meas, valid = jx_programs.block_structs()
    oracle = jx_programs.Program(
        "oracle_as_fused", jx_executor.eval_partials,
        (num, cat, meas, jx_programs.abstract_snippets(), valid),
        frozenset({"fused"}))
    want = jx_rules.check_no_tq_buffer(oracle)
    got = pt_rules.check_no_tq_buffer(_program(
        "oracle_as_fused", executor.eval_partials,
        pt_progs["eval_partials"].args, {"fused"}))
    assert _records(got) == _records(want) == [
        ("T005", ERROR, "program:oracle_as_fused")]
    assert "(1500, 200)" in got[0].message
    # The fused program: clean in the reference's lowered module; on the
    # CPU the port's wrapper runs its plain version, one info naming the
    # card's check.
    assert jx_rules.check_no_tq_buffer(jx_progs["eval_partials_fused"]) == []
    info = pt_rules.check_no_tq_buffer(pt_progs["eval_partials_fused"])
    assert [(f.rule, f.severity) for f in info] == [("T005", INFO)]
    assert "phase 12" in info[0].message


# -------------------------------------------- T001: the untiled fold bug


def _reverted_masked_tile_fold(mask, payload):
    """masked_tile_fold as it stood before its fixed tiles: pads only the
    tuple axis and contracts the full snippet width in one variable-shape
    product per tuple tile, so the contraction order changed with Q
    padding."""
    t, q = mask.shape
    tp = -(-t // SCAN_TILE_T) * SCAN_TILE_T
    mask = torch.cat([mask, mask.new_zeros((tp - t, q))])
    payload = torch.cat([payload, payload.new_zeros((tp - t,
                                                     payload.shape[1]))])
    acc = payload.new_zeros((q, payload.shape[1]))
    for i in range(tp // SCAN_TILE_T):
        sl = slice(i * SCAN_TILE_T, (i + 1) * SCAN_TILE_T)
        acc = acc + mask[sl].T @ payload[sl]
    return acc


def test_t001_reverted_fold_reproduces_the_untiled_fold_bug():
    p = _program("reverted_masked_tile_fold", _reverted_masked_tile_fold,
                 _mask_payload(), {"fold-dot"})
    found = pt_rules.check_fold_dot_shapes(p)
    assert found and all(f.rule == "T001" and f.severity == ERROR
                         for f in found)
    assert any(f"(512, {REP_Q})" in f.message for f in found)


def test_t001_requires_a_fold_dot_at_all():
    p = _program("sum_everything", lambda m, pl: m.sum() + pl.sum(),
                 _mask_payload(), {"fold-dot"})
    found = pt_rules.check_fold_dot_shapes(p)
    assert [f.rule for f in found] == ["T001"]
    assert "no tuple-axis fold dot" in found[0].message


def test_t001_canonical_programs_fold_in_fixed_tiles(pt_progs):
    for name in ("masked_tile_fold", "_partials_from_mask", "eval_partials",
                 "eval_partials_fused", "masked_partials_fused"):
        products = list(pt_rules.fold_products(pt_progs[name].trace()))
        # 3 tuple tiles x 2 snippet tiles of (128, 512) x (512, 2M + 1)
        assert [(lhs.shape, rhs.shape) for _, lhs, rhs in products] == [
            ((SCAN_TILE_Q, SCAN_TILE_T), (SCAN_TILE_T, 2 * REP_M + 1))] * 6
        assert pt_rules.check_fold_dot_shapes(pt_progs[name]) == []


# ------------------------------------------------------- T002: fold order


def _tiled_fold(mask, payload, order="asc", shape_tree=False):
    tt, tq = SCAN_TILE_T, SCAN_TILE_Q
    t, q = mask.shape
    tp, qp = -(-t // tt) * tt, -(-q // tq) * tq
    mask = torch.nn.functional.pad(mask, (0, qp - q, 0, tp - t))
    payload = torch.nn.functional.pad(payload, (0, 0, 0, tp - t))
    cols = []
    for j in range(qp // tq):
        dots = [mask[i * tt:(i + 1) * tt, j * tq:(j + 1) * tq].T
                @ payload[i * tt:(i + 1) * tt] for i in range(tp // tt)]
        if shape_tree:
            acc = (dots[0] + dots[1]) + (dots[2] + dots[0])
        elif order == "desc":
            acc = dots[-1]
            for d in reversed(dots[:-1]):
                acc = acc + d
        else:
            acc = dots[0]
            for d in dots[1:]:
                acc = acc + d
        cols.append(acc)
    return torch.cat(cols, 0)[:q]


def test_t002_descending_fold_flagged():
    p = _program("descending_fold",
                 functools.partial(_tiled_fold, order="desc"),
                 _mask_payload(), {"fold-order"})
    found = pt_rules.check_fold_order(p)
    assert found and _rules(found) == {"T002"}
    assert any("ascending" in f.message for f in found)


def test_t002_tree_fold_flagged():
    p = _program("tree_fold", functools.partial(_tiled_fold, shape_tree=True),
                 _mask_payload(), {"fold-order"})
    found = pt_rules.check_fold_order(p)
    assert found and _rules(found) == {"T002"}
    assert any("tree" in f.message for f in found)


def test_t002_canonical_fold_clean():
    p = _program("ok", executor.masked_tile_fold, _mask_payload(),
                 {"fold-order"})
    assert pt_rules.check_fold_order(p) == []
    p = _program("ok_fixture", _tiled_fold, _mask_payload(), {"fold-order"})
    assert pt_rules.check_fold_order(p) == []


# ---------------------------------------- T003/T004: cross-shard discipline


def _shard_block(n_shards=8):
    num, cat, _, valid = pt_programs.rep_block(CPU)
    return executor.pad_tuple_axis(n_shards, num, cat, None, valid)


def _cross_shard_mask_build(mesh, num, cat, valid):
    """Each shard's rows less a sum over every shard: one cross-shard op
    (the reference fixture's ``v - psum(v.sum())``)."""
    shards = executor.place_shards(mesh, num, cat, valid)
    total = torch.stack([v.sum() for _, _, v in shards]).sum()
    return torch.cat([v - total for _, _, v in shards])


def _psum_mask_build():
    mesh = executor.Mesh(("cpu",) * 8)
    num, cat, _, valid = _shard_block()
    return _program("psum_mask_build",
                    functools.partial(_cross_shard_mask_build, mesh),
                    (num, cat, valid), {"mask-build", "agg"},
                    t=num.shape[0], q=2)


def test_t003_stray_cross_shard_sum_flagged():
    found = pt_rules.check_mask_build_collectives(_psum_mask_build())
    assert [f.rule for f in found] == ["T003"]
    assert "1 cross-shard op" in found[0].message
    assert "aten.sum" in found[0].message


def test_t004_bound_zero_flags_the_same_sum():
    assert _rules(pt_rules.check_agg_collectives(_psum_mask_build(),
                                                 bound=0)) == {"T004"}
    assert pt_rules.check_agg_collectives(_psum_mask_build(), bound=1) == []


def _gathered_then_reduced(mesh, num, cat, valid):
    """A gather, row-local work on the gathered rows, then one reduction
    over the tuple axis."""
    shards = executor.place_shards(mesh, num, cat, valid)
    rows = torch.cat([n.to("cpu") for n, _, _ in shards])[:1500]
    scaled = (rows * 2.0).sum(1)  # pointwise, then a reduction over dim 1
    return scaled, scaled.sum()  # the one cross-shard op


def test_t003_labels_follow_gathers_and_row_local_ops():
    mesh = executor.Mesh(("cpu",) * 4)
    num, cat, _, valid = _shard_block(4)
    p = _program("gather", functools.partial(_gathered_then_reduced, mesh),
                 (num, cat, valid), {"mask-build"})
    ops = pt_rules.cross_shard_ops(p.trace())
    assert [rec.op for rec, _ in ops] == ["aten.sum.default"]
    # rows 1536.. (shard 3) are padding the slice drops
    assert ops[0][1] == frozenset(range(3))


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_t003_real_mask_build_is_shard_local(n_shards):
    p = pt_programs.sharded_mask_program(CPU, n_shards=n_shards)
    assert len(set(p.trace().shards.values())) == n_shards
    assert pt_rules.check_mask_build_collectives(p) == []
    assert p.t == executor.padded_tuple_count(REP_T, n_shards)


# ------------------------------------------------------------ T006: dtype


def test_t006_f32_leak_flagged():
    def leaky(mask, payload):
        lossy = mask.to(torch.float32).to(torch.float64)
        return executor.masked_tile_fold(lossy, payload)

    p = _program("f32_leak", leaky, _mask_payload(), {"partials-f64"})
    found = pt_rules.check_partials_f64(p)
    assert found and _rules(found) == {"T006"}
    assert any("f64 -> f32 conversion" in f.message for f in found)


def test_t006_f32_output_flagged():
    p = _program("f32_out",
                 lambda m, pl: (m.T @ pl).to(torch.float32),
                 _mask_payload(), {"partials-f64"})
    found = pt_rules.check_partials_f64(p)
    assert any("output has dtype float32" in f.message for f in found)


def test_t006_f32_made_from_f64_flagged():
    def drift(mask, payload):
        out = executor.masked_tile_fold(mask, payload)
        buf = torch.empty(out.shape, dtype=torch.float32)
        torch.add(out, 1.0, out=buf)  # float64 in, float32 out
        return out

    p = _program("f32_made", drift, _mask_payload(), {"partials-f64"})
    found = pt_rules.check_partials_f64(p)
    assert [f.rule for f in found] == ["T006"]
    assert "produces f32 from f64" in found[0].message


# ------------------------------------------------------------ T007: launches


def _dispatcher(leak):
    """The improve dispatch with the Q padding kept (``leak=False``) or
    dropped: an unpadded Q reaching ``gp_batch_infer``'s launch."""
    from repro_torch.core.synopsis import _improve_inputs, _pad_raw
    from repro_torch.core.types import bucket_size, pad_snippets
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops

    def dispatch(syn, new, raw):
        qb = new.n if leak else bucket_size(new.n, syn.min_q_bucket)
        new = pad_snippets(new, qb)
        past, valid, sinv, alpha = syn._padded_state()
        k, kappa2, mu = _improve_inputs(past, valid, syn.params, new)
        return gp_ops.gp_batch_infer(
            k, sinv, alpha, kappa2, mu, _pad_raw(raw.theta, qb, 0.0),
            _pad_raw(raw.beta2, qb, 1.0), live=syn.n)

    return dispatch


def test_t007_launch_key_leak_flagged():
    found = pt_rules.check_improve_cache_cardinality(
        dispatch=_dispatcher(leak=True), device="cpu")
    assert [f.rule for f in found] == ["T007"]
    assert "12 launch signature(s)" in found[0].message
    assert "expected exactly 9" in found[0].message


def test_t007_bucketed_dispatch_clean():
    assert pt_rules.check_improve_cache_cardinality(
        dispatch=_dispatcher(leak=False), device="cpu") == []


def test_call_tap_restores_the_profiler_and_sees_each_call():
    import sys

    from repro_torch.kernels.fused_masked_scan import ops as fms_ops

    before = sys.getprofile()
    num, cat, meas, valid = pt_programs.rep_block(CPU, t=40)
    snips = pt_programs.rep_snippets(CPU, q=3)
    with pt_programs.CallTap(fms_ops.fused_masked_scan) as tap:
        fms_ops.eval_partials_fused(num, cat, meas, snips, valid)
        fms_ops.eval_partials_fused(num[:30], cat[:30], meas[:30], snips)
    assert sys.getprofile() is before
    assert [c["x"].shape[0] for _, c in tap.calls] == [40, 30]
    assert len(tap.returns) == 2
    assert len({pt_rules.k1_signature(c) for _, c in tap.calls}) == 2


# --------------------------------------------------- the real tree, the CLI


@pytest.fixture(scope="module")
def trace_findings():
    return pt_rules.run_trace_rules(device="cpu")


def test_repo_trace_layer_is_clean_on_the_cpu(trace_findings):
    bad = [f for f in trace_findings if f.severity in (ERROR, WARN)]
    assert gate_count(trace_findings, strict=True) == 0, render_text(bad)
    assert _records(trace_findings) == [
        ("T005", INFO, "program:eval_partials_fused")]


def test_trace_rules_are_the_reference_s():
    assert pt_rules.TRACE_RULES == jx_rules.TRACE_RULES


@pytest.mark.parametrize("layer", ["trace", "all"])
def test_cli_layer_on_the_cpu_exits_zero(layer, capsys):
    rc = main(["--layer", layer, "--device", "cpu", "--strict"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 error, 0 warn" in out


def test_cli_json_carries_trace_findings(capsys):
    rc = main(["--layer", "trace", "--device", "cpu", "--format", "json"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert data and all(d["rule"].startswith("T") for d in data)


def test_cli_trace_layer_without_a_card_fails_loudly(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--layer", "trace"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_repo_analysis(layers=("trace",))
    # the AST layer needs no device
    assert main(["--layer", "ast", "--strict"]) == 0


def test_port_rules_keep_the_new_modules_clean():
    found = pt_ast.run_ast_rules(rules=["A005"])
    assert gate_count(found, strict=True) == 0, render_text(found)
    idle = {f.message.split(":")[0] for f in found}
    assert not idle & {"repro_torch.analysis.programs",
                       "repro_torch.analysis.trace_rules"}
