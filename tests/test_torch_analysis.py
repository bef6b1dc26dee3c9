"""The port's static checker, AST layer (``repro_torch.analysis``: rules
A001-A008, the findings and the CLI) against the JAX reference's
``repro.analysis.ast_rules`` (CPU).

Both packages' rules run on ``tests/badrepo/`` (read only) and must give
the same findings, rule by rule: the same rule ids, severities and
locations, and the same messages once the package's name is the same (A005
names what imports a module in its own words). Only
``repro.analysis.ast_rules`` and ``repro.analysis.findings`` are imported
from the reference, never its trace layer.

The port's clock/RNG detector takes torch's RNG in place of
``jax.random``: fixtures written into ``tmp_path`` (a kernel file, an
intel file, a front decision module) use it, and each is flagged by
exactly its rule. The port's own tree is clean under ``--strict`` (both
layers, the trace layer on the CPU), its inventory entries each carry their
reason, and the CLI runs the AST layer alone; the trace layer and its CLI
are held in ``tests/test_torch_trace.py``.
"""
import json
import pathlib

import pytest

from repro.analysis import ast_rules as jx_rules
from repro.analysis import findings as jx_findings
from repro_torch.analysis import ast_rules as pt_rules
from repro_torch.analysis import findings as pt_findings
from repro_torch.analysis.cli import main, run_repo_analysis

BADREPO = pathlib.Path(__file__).resolve().parent / "badrepo"

# (rule, the check, its keywords): every AST rule, as the reference's tests
# call it on the fixtures.
RULE_CHECKS = [
    ("A001", "check_synopses_access", {}),
    ("A002", "check_guarded_apply", {}),
    ("A003", "check_fault_seams", {}),
    ("A004", "check_kernel_determinism", {}),
    ("A006", "check_epsilon_discipline", {"scope": None}),
    ("A007", "check_intel_determinism", {}),
    ("A008", "check_front_determinism", {}),
]


def _records(findings, package):
    return [(f.rule, f.severity, f.location,
             f.message.replace(package + ".", "<pkg>."),
             f.hint.replace(package + ".", "<pkg>.")) for f in findings]


@pytest.mark.parametrize("rule,check,kw", RULE_CHECKS,
                         ids=[r for r, _, _ in RULE_CHECKS])
def test_badrepo_findings_equal_the_reference(rule, check, kw):
    got = getattr(pt_rules, check)(pt_rules.parse_tree(BADREPO), **kw)
    want = getattr(jx_rules, check)(jx_rules.parse_tree(BADREPO), **kw)
    assert want, "the fixture must trip the rule"
    assert {f.rule for f in got} == {rule}
    got_r = _records(got, "repro_torch")
    want_r = _records(want, "repro")
    assert [r[:3] for r in got_r] == [r[:3] for r in want_r]
    assert got_r == want_r


def test_a005_badrepo_findings_equal_the_reference():
    got = pt_rules.check_dead_code(BADREPO, importer_roots=())
    want = jx_rules.check_dead_code(BADREPO, importer_roots=())
    assert [(f.rule, f.severity, f.location) for f in got] == [
        (f.rule, f.severity, f.location) for f in want]
    assert [f.message.split(":")[0].replace("repro_torch.", "")
            for f in got] == [f.message.split(":")[0].replace("repro.", "")
                              for f in want]
    orphans = [f for f in got if f.location == "orphan.py"]
    assert orphans and orphans[0].severity == pt_findings.ERROR
    assert "dead module" in orphans[0].message


def test_whole_ast_layer_on_badrepo_equals_the_reference():
    """Every rule at once, as ``run_ast_rules`` runs them, rooted at the
    fixtures: the same (rule, severity, location) multiset."""
    got = pt_rules.run_ast_rules(src_root=BADREPO, repo_root=BADREPO)
    want = jx_rules.run_ast_rules(src_root=BADREPO, repo_root=BADREPO)
    key = (lambda f: (f.rule, f.severity, f.location))
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert ({f.rule for f in got} == set(pt_rules.AST_RULES)
            - {"A006"})  # the fixture's epsilon sits outside A006's scope


def test_a003_unwrapped_registration_flagged():
    found = pt_rules.check_fault_seams([], points=("ghost.seam",))
    assert [f.rule for f in found] == ["A003"]
    assert "never wrapped" in found[0].message


def test_a003_registry_is_the_references():
    from repro.ft.faults import POINTS as jx_points
    from repro_torch.ft.faults import POINTS as pt_points

    assert pt_points == jx_points


def test_a006_definition_site_is_excluded_by_name():
    bad = pt_rules.parse_tree(BADREPO)
    found = pt_rules.check_epsilon_discipline(bad, scope=None)
    assert found[0].location.startswith("local_eps.py:")
    assert "1e-07" in found[0].message
    assert pt_rules.check_epsilon_discipline(
        bad, scope=None, def_sites=("local_eps.py",)) == []


def test_a008_scope_is_exactly_the_decision_modules():
    assert set(pt_rules.FRONT_DECISION_MODULES) == {
        "serving/front/admission.py", "serving/front/metrics.py"}
    assert pt_rules.AST_RULES == jx_rules.AST_RULES
    for rel in pt_rules.FRONT_DECISION_MODULES:
        assert (pt_rules.SRC_ROOT / rel).is_file()


def test_findings_module_is_the_references():
    f = pt_findings.Finding("A005", pt_findings.WARN, "x.py", "m", "h")
    g = jx_findings.Finding("A005", jx_findings.WARN, "x.py", "m", "h")
    assert f.as_dict() == g.as_dict()
    with pytest.raises(ValueError):
        pt_findings.Finding("A001", "fatal", "x.py", "m")
    fs = [f, pt_findings.Finding("A001", pt_findings.ERROR, "y.py:3", "n"),
          pt_findings.Finding("A005", pt_findings.INFO, "z.py", "o")]
    gs = [g, jx_findings.Finding("A001", jx_findings.ERROR, "y.py:3", "n"),
          jx_findings.Finding("A005", jx_findings.INFO, "z.py", "o")]
    assert pt_findings.render_text(fs) == jx_findings.render_text(gs)
    assert pt_findings.render_json(fs) == jx_findings.render_json(gs)
    assert [pt_findings.gate_count(fs, strict=s) for s in (True, False)] == [
        jx_findings.gate_count(gs, strict=s) for s in (True, False)] == [2, 1]


# ------------------------------------------------ torch's RNG, per rule


TORCH_RNG_USES = [
    ("import torch\n\ndef f(x):\n    return x + torch.rand(3)\n",
     "uses torch.rand"),
    ("import torch\n\ndef f(x):\n    return torch.randn_like(x)\n",
     "uses torch.randn_like"),
    ("import torch\n\ndef f(n):\n    return torch.randperm(n)\n",
     "uses torch.randperm"),
    ("import torch\n\ndef f(p):\n    return torch.bernoulli(p)\n",
     "uses torch.bernoulli"),
    ("import torch\n\ntorch.manual_seed(0)\n", "uses torch.manual_seed"),
    ("import torch\n\nG = torch.Generator()\n", "uses torch.Generator"),
    ("import torch\n\ndef f():\n    return torch.random.initial_seed()\n",
     "uses torch.random"),
    ("import torch.random\n", "imports torch.random"),
    ("from torch import Generator, randint\n",
     "imports torch.Generator, torch.randint"),
    ("from torch.random import fork_rng\n", "imports from torch.random"),
]

# (rule, the fixture's path in a tree laid out like the port's)
RNG_FIXTURES = [
    ("A004", "kernels/jittery/ops.py"),
    ("A007", "intel/router_noise.py"),
    ("A008", "serving/front/admission.py"),
]


def _file_rules(files):
    """Every file-level rule (all but A005) over ``files``."""
    out = []
    out += pt_rules.check_synopses_access(files)
    out += pt_rules.check_guarded_apply(files)
    out += pt_rules.check_fault_seams(files, points=())
    out += pt_rules.check_kernel_determinism(files)
    out += pt_rules.check_epsilon_discipline(files)
    out += pt_rules.check_intel_determinism(files)
    out += pt_rules.check_front_determinism(files)
    return out


@pytest.mark.parametrize("rule,path", RNG_FIXTURES,
                         ids=[r for r, _ in RNG_FIXTURES])
def test_torch_rng_is_flagged_by_exactly_its_rule(tmp_path, rule, path):
    for i, (code, what) in enumerate(TORCH_RNG_USES):
        root = tmp_path / f"case{i}"
        target = root / path
        target.parent.mkdir(parents=True)
        target.write_text(code)
        # The same use outside every determinism scope: no rule's business.
        (root / "aqp").mkdir()
        (root / "aqp" / "workload.py").write_text(code)
        found = _file_rules(pt_rules.parse_tree(root))
        assert [f.rule for f in found] == [rule], (code, found)
        assert found[0].location.startswith(path + ":")
        assert what in found[0].message, (what, found[0].message)


def test_torch_use_without_rng_is_clean(tmp_path):
    for _, path in RNG_FIXTURES:
        target = tmp_path / path
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text("import torch\nfrom torch import nn\n\n"
                          "def f(x):\n    return torch.randn_free(x) if "
                          "False else torch.sort(x).values + x.rand\n")
    assert _file_rules(pt_rules.parse_tree(tmp_path)) == []


# ------------------------------------------------- the port's own tree


@pytest.fixture(scope="module")
def repo_findings():
    return run_repo_analysis(device="cpu")


def test_repo_is_clean_under_strict_gate(repo_findings):
    bad = [f for f in repo_findings if f.severity != pt_findings.INFO]
    assert pt_findings.gate_count(repo_findings, strict=True) == 0, \
        pt_findings.render_text(bad)


def test_repo_inventory_is_explicit(repo_findings):
    inv = [f for f in repo_findings if f.rule == "A005"]
    assert inv and all(f.severity == pt_findings.INFO for f in inv)
    assert all("kept:" in f.message for f in inv)
    # Every keep-reason names a module that exists and is idle in the port:
    # no stale allowlist entry.
    idle = {f.message.split(":")[0] for f in inv}
    assert idle == set(pt_rules.IDLE_KEEP)


def test_importer_roots_are_what_imports_the_port():
    roots = pt_rules.importer_roots()
    names = {p.name for p in roots}
    assert {"chip_smoke.py", "tools", "test_torch_front.py",
            "test_torch_analysis.py"} <= names
    assert not any(p.name.startswith("test_") and
                   not p.name.startswith("test_torch_") for p in roots)


def test_cli_ast_layer_exits_zero(capsys):
    rc = main(["--layer", "ast", "--strict"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "finding" in out


def test_cli_json_format(capsys):
    rc = main(["--layer", "ast", "--rules", "A005", "--format", "json"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert data and all(d["rule"] == "A005" for d in data)
