"""``python -m repro_torch.analysis`` — run the port's invariant checker and
gate on it.

Exit status is the number of gating findings (0 = contracts hold), so CI
can use the process status directly. ``--strict`` (the CI mode) also gates
on warnings, forcing every idle module / unverifiable seam into an explicit
allowlist entry rather than a lingering warning.

Only the AST layer is ported. The reference's trace layer (T001-T007, over
jaxprs and StableHLO) has no torch counterpart yet, so ``--layer trace`` is
refused with an error (ROADMAP Queue 1) instead of returning no findings.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import (Finding, gate_count, render_json,
                                           render_text)

LAYERS = ("ast",)
NOT_PORTED = {"trace": "the trace layer (T001-T007) is not ported to "
                       "repro_torch yet (ROADMAP Queue 1: the static "
                       "checker's trace analogs)"}


def run_repo_analysis(
    layers: Sequence[str] = LAYERS,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """All findings for the port's source tree (the AST layer)."""
    for layer in layers:
        if layer in NOT_PORTED:
            raise ValueError(NOT_PORTED[layer])
        if layer not in LAYERS:
            raise ValueError(f"unknown layer {layer!r}; expected one of "
                             f"{LAYERS}")
    from repro_torch.analysis.ast_rules import run_ast_rules

    out = run_ast_rules(rules=rules)
    if rules is not None:
        out = [f for f in out if f.rule in set(rules)]
    return out


def violation_count(strict: bool = True) -> int:
    """Gating finding count of the port's tree."""
    return gate_count(run_repo_analysis(), strict=strict)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker for the port's access-path "
                    "and determinism contracts",
    )
    ap.add_argument("--strict", action="store_true",
                    help="gate on warnings too (CI mode)")
    ap.add_argument("--layer", choices=("all",) + LAYERS + tuple(NOT_PORTED),
                    default="all",
                    help="run only the AST layer (default: all, which is "
                         "the AST layer; the trace layer is not ported)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (e.g. A005,A008)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    if args.layer in NOT_PORTED:
        ap.error(f"--layer {args.layer}: {NOT_PORTED[args.layer]}")
    layers = LAYERS if args.layer == "all" else (args.layer,)
    rules = args.rules.split(",") if args.rules else None
    findings = run_repo_analysis(layers=layers, rules=rules)
    render = render_json if args.format == "json" else render_text
    print(render(findings))
    return gate_count(findings, strict=args.strict)
