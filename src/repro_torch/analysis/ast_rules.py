"""The port's static checker, AST layer: rules over ``src/repro_torch``.

The reference's access-path rules (``repro.analysis.ast_rules``), retargeted
at the port's tree. They enforce the discipline that keeps the engine's
state and its bitwise contracts flowing through one path:

A001  ``.synopses`` access only through the owner (``core/store.py``) and
      the engine (``core/engine.py``) — every other caller must go through
      the ``SynopsisStore`` API so placement/quarantine bookkeeping cannot
      be bypassed.
A002  ``Synopsis`` state is mutated only via ``_guarded_apply`` (and its
      ``heal`` replay): a direct ``_apply_add`` call skips the quarantine
      fence and lets a failed covariance build corrupt serving state.
A003  fault-seam registry/call-site coherence: every string passed to
      ``faults.fire`` is a registered point in
      ``repro_torch.ft.faults.POINTS``, and every registered point is
      actually wrapped at >= 1 call site.
A004  determinism inside ``repro_torch.kernels``: no wall-clock, no RNG —
      kernel outputs must be pure functions of their operands (bitwise
      parity with the plain versions depends on it).
A005  dead-code inventory: every module is imported somewhere (the port,
      its tests ``tests/test_torch_*.py``, ``chip_smoke.py`` or ``tools/``),
      a known entry point, or carries an explicit keep-reason in the
      allowlist.
A006  epsilon discipline: no local epsilon literal in the half-open band
      (1e-15, 1e-5] inside the kernels' Python or the executor — the shared
      ``RANGE_EPS`` (``repro_torch.kernels``) is the single source of truth.
A007  determinism inside ``repro_torch.intel``: no wall-clock and no RNG in
      the workload-intelligence plane — cache keys and router features must
      be pure functions of the plan IR and engine state.
A008  clock-free serving-front decision modules: admission control and
      metrics bucketing (``serving/front/{admission,metrics}.py``) take
      timestamps/durations as arguments — the transport layer owns the
      clock — so admission decisions are seedable and replay exactly.

The clock/RNG detector behind A004/A007/A008 is the reference's, with
torch's RNG (``torch.random``, ``torch.rand``/``randn``/``randint``/
``randperm``/``normal``/``bernoulli`` and their ``_like`` forms,
``torch.manual_seed``, ``torch.Generator``) in place of ``jax.random``.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.analysis.findings import ERROR, INFO, WARN, Finding

PACKAGE = "repro_torch"
SRC_ROOT = pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch
REPO_ROOT = SRC_ROOT.parents[1]

# --------------------------------------------------------------- allowlists

# A001: the only files allowed to touch `.synopses` / `._synopses`.
SYNOPSES_ALLOW = ("core/store.py", "core/engine.py")
# A002: the only (file, enclosing function) pairs allowed to call _apply_add.
GUARDED_APPLY_ALLOW = ("_guarded_apply", "heal")
# A006: where the shared epsilon is *defined* (literals allowed there).
EPSILON_DEF_SITE = ("kernels/__init__.py",)

# A005 (the port registers no module dynamically, so it has no dynamic-import
# allowlist). Entry points: roots of the import graph by design.
ENTRY_POINTS = {
    "repro_torch.analysis.__main__": "CLI (python -m repro_torch.analysis)",
    "repro_torch.analysis.cli": "CLI implementation module",
    "repro_torch.launch.train": "CLI (python -m repro_torch.launch.train)",
}
# Idle-but-kept: reachable only from the tests, chip_smoke.py or tools/;
# each entry records WHY it stays.
IDLE_KEEP = {
    "repro_torch.aqp.online": "online-aggregation comparison baseline for "
                              "the paper's §7 accuracy study; "
                              "tests/test_torch_inference.py",
    "repro_torch.aqp.workload": "relation and workload generators (TPC-H "
                                "SF1 lineitem for chip_smoke.py) shared by "
                                "the tests, chip_smoke.py and tools/",
    "repro_torch.launch": "the package of the trainer's entry point "
                          "(python -m repro_torch.launch.train) and the "
                          "roofline terms; nothing imports the package "
                          "itself",
    "repro_torch.launch.roofline": "the H100 roofline terms and model "
                                   "FLOPs; chip_smoke.py phase 11 reads "
                                   "model_flops; its importers in the "
                                   "reference (launch/cells.py, "
                                   "launch/hlo_analysis.py) are not ported "
                                   "yet",
}


# ------------------------------------------------------------- file parsing


@dataclasses.dataclass
class ParsedFile:
    path: pathlib.Path
    rel: str  # posix path relative to the scanned root, e.g. "core/store.py"
    tree: ast.AST


def parse_tree(root: pathlib.Path) -> List[ParsedFile]:
    root = pathlib.Path(root)
    out = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        out.append(ParsedFile(p, rel, ast.parse(p.read_text(), str(p))))
    return out


def _loc(pf: ParsedFile, node: ast.AST) -> str:
    return f"{pf.rel}:{getattr(node, 'lineno', 0)}"


# ------------------------------------------------------------------- A001


def check_synopses_access(
    files: Sequence[ParsedFile],
    allow: Sequence[str] = SYNOPSES_ALLOW,
) -> List[Finding]:
    out: List[Finding] = []
    for pf in files:
        if pf.rel in allow:
            continue
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr in ("synopses", "_synopses"):
                out.append(Finding(
                    "A001", ERROR, _loc(pf, node),
                    f"direct `.{node.attr}` access outside the store and "
                    "the deprecated engine shim",
                    "go through the SynopsisStore API (get/ensure/items/"
                    "state_dict); the dict is an implementation detail and "
                    "bypassing it skips placement + quarantine bookkeeping",
                ))
    return out


# ------------------------------------------------------------------- A002


def check_guarded_apply(
    files: Sequence[ParsedFile],
    owner_file: str = "core/synopsis.py",
    allow_fns: Sequence[str] = GUARDED_APPLY_ALLOW,
) -> List[Finding]:
    out: List[Finding] = []

    class V(ast.NodeVisitor):
        def __init__(self, pf: ParsedFile):
            self.pf = pf
            self.stack: List[str] = []

        def visit_FunctionDef(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name == "_apply_add":
                ok = (self.pf.rel == owner_file
                      and any(s in allow_fns for s in self.stack))
                if not ok:
                    out.append(Finding(
                        "A002", ERROR, _loc(self.pf, node),
                        "`_apply_add` called outside "
                        f"{owner_file}:{'/'.join(allow_fns)} — Synopsis "
                        "state mutated without the quarantine fence",
                        "route the batch through Synopsis._guarded_apply "
                        "(add/drain do); a raising _apply_add must park the "
                        "batch and quarantine, never propagate",
                    ))
            self.generic_visit(node)

    for pf in files:
        V(pf).visit(pf.tree)
    return out


# ------------------------------------------------------------------- A003


def check_fault_seams(
    files: Sequence[ParsedFile],
    points: Optional[Sequence[str]] = None,
) -> List[Finding]:
    if points is None:
        from repro_torch.ft.faults import POINTS as points  # registry of record
    out: List[Finding] = []
    seen: Set[str] = set()
    for pf in files:
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name != "fire" or not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value in points:
                    seen.add(arg.value)
                else:
                    out.append(Finding(
                        "A003", ERROR, _loc(pf, node),
                        f"fire({arg.value!r}) names a fault seam that is "
                        "not registered in repro_torch.ft.faults.POINTS",
                        "add the point to POINTS (with a docstring line "
                        "describing the seam) or fix the typo; unregistered "
                        "seams are invisible to FaultPlan and chaos tests",
                    ))
            else:
                out.append(Finding(
                    "A003", WARN, _loc(pf, node),
                    "fire() called with a non-literal point name — the "
                    "registry check cannot verify it statically",
                    "pass the seam name as a string literal",
                ))
    for point in points:
        if point not in seen:
            out.append(Finding(
                "A003", ERROR, f"registry:{point}",
                f"fault seam {point!r} is registered in POINTS but never "
                "wrapped at any call site",
                "call faults.fire({!r}) at the seam it documents, or drop "
                "the registration".format(point),
            ))
    return out


# ----------------------------------------------------- A004 / A007 / A008

_CLOCK_RNG_MODULES = {"time", "random", "secrets", "datetime"}
_RNG_ATTR_BASES = {"np", "numpy", "torch"}
# torch's samplers, seeders and generator objects.
_TORCH_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "bernoulli",
              "manual_seed", "Generator"}


def _clock_rng_uses(tree: ast.AST):
    """Yield ``(node, description)`` for every wall-clock/RNG use: imports
    of the clock/RNG stdlib modules, imports of ``torch.random`` or of
    torch's RNG functions, ``np/numpy/torch .random`` attribute access and
    ``torch.<sampler>`` attribute access. The shared detector behind the
    determinism rules (A004 kernels, A007 intel, A008 serving front)."""
    for node in ast.walk(tree):
        bad = None
        if isinstance(node, ast.Import):
            mods = [a.name.split(".")[0] for a in node.names]
            hit = sorted(set(mods) & _CLOCK_RNG_MODULES)
            if hit:
                bad = f"imports {', '.join(hit)}"
            elif any(a.name == "torch.random"
                     or a.name.startswith("torch.random.")
                     for a in node.names):
                bad = "imports torch.random"
        elif isinstance(node, ast.ImportFrom) and node.module:
            top = node.module.split(".")[0]
            names = {a.name for a in node.names}
            if top in _CLOCK_RNG_MODULES:
                bad = f"imports from {node.module}"
            elif node.module == "torch.random" \
                    or node.module.startswith("torch.random."):
                bad = f"imports from {node.module}"
            elif node.module == "torch" and names & (_TORCH_RNG | {"random"}):
                bad = ("imports torch."
                       + ", torch.".join(sorted(names & (_TORCH_RNG
                                                         | {"random"}))))
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            if node.attr == "random" and node.value.id in _RNG_ATTR_BASES:
                bad = f"uses {node.value.id}.random"
            elif node.value.id == "torch" and node.attr in _TORCH_RNG:
                bad = f"uses torch.{node.attr}"
        if bad:
            yield node, bad


def _in_kernels(rel: str) -> bool:
    return rel.startswith("kernels/")


def check_kernel_determinism(
    files: Sequence[ParsedFile],
    scope: Optional[Callable[[str], bool]] = _in_kernels,
) -> List[Finding]:
    out: List[Finding] = []
    for pf in files:
        if scope is not None and not scope(pf.rel):
            continue
        for node, bad in _clock_rng_uses(pf.tree):
            out.append(Finding(
                "A004", ERROR, _loc(pf, node),
                f"kernel module {bad} — wall-clock/RNG inside "
                "repro_torch.kernels breaks determinism",
                "kernel outputs must be pure functions of their "
                "operands (bitwise parity depends on it); thread keys/"
                "timestamps in from the caller if truly needed",
            ))
    return out


def _in_intel(rel: str) -> bool:
    return rel.startswith("intel/")


def check_intel_determinism(
    files: Sequence[ParsedFile],
    scope: Optional[Callable[[str], bool]] = _in_intel,
) -> List[Finding]:
    """A004's discipline applied to the workload-intelligence plane.

    Cache-key derivation (``QuerySignature``) and router features must be
    pure functions of the plan IR and engine state: a wall-clock read makes
    staleness decisions replay-dependent, an RNG draw makes two processes
    derive different keys for the same query (and ``hash()`` randomization
    is why keys go through blake2b, never ``hash()``).
    """
    out: List[Finding] = []
    for pf in files:
        if scope is not None and not scope(pf.rel):
            continue
        for node, bad in _clock_rng_uses(pf.tree):
            out.append(Finding(
                "A007", ERROR, _loc(pf, node),
                f"intel module {bad} — wall-clock/RNG inside "
                "repro_torch.intel breaks cache-key/router determinism",
                "cache keys and router features must be pure functions "
                "of the plan IR and engine state (generation counters, "
                "fill buckets); measure latency in benchmarks, never in "
                "the serving plane",
            ))
    return out


# A008: clock-free serving-front decision modules. The transport/composition
# layer (front.py, http.py) legitimately measures time; the DECISION modules
# (admission, metrics bucketing) must stay pure functions of injected
# timestamps so admission traces replay deterministically.
FRONT_DECISION_MODULES = (
    "serving/front/admission.py",
    "serving/front/metrics.py",
)


def _in_front_decisions(rel: str) -> bool:
    return rel in FRONT_DECISION_MODULES


def check_front_determinism(
    files: Sequence[ParsedFile],
    scope: Optional[Callable[[str], bool]] = _in_front_decisions,
) -> List[Finding]:
    """The determinism discipline applied to the serving front's decision
    modules: admission (token bucket, queue bound) and metrics (latency
    bucketing) take ``now``/durations as ARGUMENTS — a direct clock read or
    RNG draw there makes admission decisions unreplayable and rate-limit
    tests flaky. The transport layer owns the clock and injects it.
    """
    out: List[Finding] = []
    for pf in files:
        if scope is not None and not scope(pf.rel):
            continue
        for node, bad in _clock_rng_uses(pf.tree):
            out.append(Finding(
                "A008", ERROR, _loc(pf, node),
                f"serving-front decision module {bad} — admission/metrics "
                "must be pure functions of injected timestamps",
                "take `now` (or the duration) as an argument and let the "
                "transport layer (front.py/http.py) read the clock; "
                "seedable decisions are what make admission traces replay",
            ))
    return out


# ------------------------------------------------------------------- A005


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PACKAGE] + parts) if parts else PACKAGE


def _imports_of(tree: ast.AST, self_mod: str) -> Set[str]:
    """Absolute dotted names this module imports (repro_torch.* only)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == PACKAGE or a.name.startswith(PACKAGE + "."):
                    out.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = self_mod.split(".")
                # from the module's package, go up (level - 1) more
                base = base[: len(base) - node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if not (mod == PACKAGE or mod.startswith(PACKAGE + ".")):
                continue
            out.add(mod)
            for a in node.names:
                out.add(f"{mod}.{a.name}")  # may be a symbol; filtered later
    return out


def check_dead_code(
    src_root: pathlib.Path = SRC_ROOT,
    importer_roots: Sequence[pathlib.Path] = (),
    idle_keep: Dict[str, str] = IDLE_KEEP,
    entry_points: Dict[str, str] = ENTRY_POINTS,
) -> List[Finding]:
    files = parse_tree(src_root)
    modules = {_module_name(pf.rel): pf for pf in files}
    importers: Dict[str, Set[str]] = {m: set() for m in modules}

    def credit(targets: Set[str], importer: str, external: bool):
        for t in targets:
            if t not in modules:
                continue
            tag = f"{'ext:' if external else ''}{importer}"
            # importing repro_torch.x.y also executes every ancestor
            # __init__, the package's own included (the reference's tree
            # has no top-level __init__.py; the port's has one)
            parts = t.split(".")
            for i in range(1, len(parts) + 1):
                anc = ".".join(parts[:i])
                if anc in importers and anc != importer:
                    importers[anc].add(tag)

    for pf in files:
        mod = _module_name(pf.rel)
        credit(_imports_of(pf.tree, mod), mod, external=False)
    for root in importer_roots:
        root = pathlib.Path(root)
        if root.is_file():
            tree = ast.parse(root.read_text(), str(root))
            credit(_imports_of(tree, "external"), root.name, external=True)
            continue
        if not root.exists():
            continue
        for ext in parse_tree(root):
            credit(_imports_of(ext.tree, "external"),
                   f"{root.name}/{ext.rel}", external=True)

    out: List[Finding] = []
    for mod in sorted(modules):
        pf = modules[mod]
        if mod in entry_points:
            continue
        who = importers[mod]
        src_importers = {w for w in who if not w.startswith("ext:")}
        if src_importers:
            continue
        if mod in idle_keep:
            out.append(Finding(
                "A005", INFO, pf.rel,
                f"{mod}: idle (no src importer); kept: {idle_keep[mod]}",
                "",
            ))
        elif who:
            out.append(Finding(
                "A005", WARN, pf.rel,
                f"{mod}: reachable only from "
                f"{', '.join(sorted(w[4:] for w in who))} — idle in src",
                "add an IDLE_KEEP entry in repro_torch/analysis/ast_rules.py "
                "with the reason it stays, or delete it",
            ))
        else:
            out.append(Finding(
                "A005", ERROR, pf.rel,
                f"{mod}: dead module — nothing in the port, its tests, "
                "chip_smoke.py or tools/ imports it",
                "delete it (git history keeps it), or register the dynamic "
                "import / entry point that reaches it",
            ))
    return out


# ------------------------------------------------------------------- A006

EPS_BAND_LO = 1e-15
EPS_BAND_HI = 1e-5


def _in_epsilon_scope(rel: str) -> bool:
    return rel.startswith("kernels/") or rel == "aqp/executor.py"


def check_epsilon_discipline(
    files: Sequence[ParsedFile],
    scope: Optional[Callable[[str], bool]] = _in_epsilon_scope,
    def_sites: Sequence[str] = EPSILON_DEF_SITE,
) -> List[Finding]:
    out: List[Finding] = []
    for pf in files:
        if pf.rel in def_sites:
            continue
        if scope is not None and not scope(pf.rel):
            continue
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, float) \
                    and EPS_BAND_LO < abs(node.value) <= EPS_BAND_HI:
                out.append(Finding(
                    "A006", ERROR, _loc(pf, node),
                    f"local epsilon literal {node.value!r} in the scan "
                    "plane — epsilon drift between kernel and oracle",
                    "import RANGE_EPS from repro_torch.kernels (the single "
                    "epsilon of record; the pre-PR-6 parity drift was a "
                    "kernel-local 1e-7 vs the oracle's 1e-12)",
                ))
    return out


# ------------------------------------------------------------------- driver

def importer_roots(repo_root: pathlib.Path = REPO_ROOT) -> List[pathlib.Path]:
    """What imports the port from outside it: its tests, ``chip_smoke.py``
    and ``tools/``."""
    repo_root = pathlib.Path(repo_root)
    return [*sorted((repo_root / "tests").glob("test_torch_*.py")),
            repo_root / "chip_smoke.py", repo_root / "tools"]


AST_RULES = ("A001", "A002", "A003", "A004", "A005", "A006", "A007", "A008")


def run_ast_rules(
    src_root: pathlib.Path = SRC_ROOT,
    repo_root: pathlib.Path = REPO_ROOT,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    rules = set(AST_RULES if rules is None else rules)
    files = parse_tree(src_root)
    out: List[Finding] = []
    if "A001" in rules:
        out.extend(check_synopses_access(files))
    if "A002" in rules:
        out.extend(check_guarded_apply(files))
    if "A003" in rules:
        out.extend(check_fault_seams(files))
    if "A004" in rules:
        out.extend(check_kernel_determinism(files))
    if "A005" in rules:
        out.extend(check_dead_code(
            src_root,
            importer_roots=importer_roots(repo_root),
        ))
    if "A006" in rules:
        out.extend(check_epsilon_discipline(files))
    if "A007" in rules:
        out.extend(check_intel_determinism(files))
    if "A008" in rules:
        out.extend(check_front_determinism(files))
    return out
