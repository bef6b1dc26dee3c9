"""``python -m repro_torch.analysis`` — run the port's invariant checker and
gate on it.

Exit status is the number of gating findings (0 = contracts hold), so CI
can use the process status directly. ``--strict`` (the CI mode) also gates
on warnings, forcing every idle module / unverifiable seam into an explicit
allowlist entry rather than a lingering warning.

Two layers, as in the reference: the AST layer (A001-A008, host-only Python
over the source tree) and the trace layer (T001-T007, over recorded runs of
the scan plane's programs). The trace layer runs the programs on
``--device``, by default the card: with no card it fails loudly unless
``--device cpu`` is given, and it never moves to the CPU by itself.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import (Finding, gate_count, render_json,
                                           render_text)

LAYERS = ("ast", "trace")


def run_repo_analysis(
    layers: Sequence[str] = LAYERS,
    rules: Optional[Sequence[str]] = None,
    device=None,
) -> List[Finding]:
    """All findings for the port (both layers by default); the trace layer
    runs on ``device`` (``None``: the card)."""
    for layer in layers:
        if layer not in LAYERS:
            raise ValueError(f"unknown layer {layer!r}; expected one of "
                             f"{LAYERS}")
    out: List[Finding] = []
    if "trace" in layers:
        from repro_torch.analysis.trace_rules import run_trace_rules

        out.extend(run_trace_rules(rules=rules, device=device))
    if "ast" in layers:
        from repro_torch.analysis.ast_rules import run_ast_rules

        out.extend(run_ast_rules(rules=rules))
    if rules is not None:
        out = [f for f in out if f.rule in set(rules)]
    return out


def violation_count(strict: bool = True, device=None) -> int:
    """Gating finding count of the port (both layers)."""
    return gate_count(run_repo_analysis(device=device), strict=strict)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker for the port's scan-plane "
                    "parity, access-path and determinism contracts",
    )
    ap.add_argument("--strict", action="store_true",
                    help="gate on warnings too (CI mode)")
    ap.add_argument("--layer", choices=("all",) + LAYERS, default="all",
                    help="run only the AST layer or only the trace layer "
                         "(default: all)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (e.g. T001,A005)")
    ap.add_argument("--device", default="cuda",
                    help="device the trace layer runs its programs on "
                         "(default: cuda; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    layers = LAYERS if args.layer == "all" else (args.layer,)
    rules = args.rules.split(",") if args.rules else None
    if "trace" in layers:
        from repro_torch.core.types import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            ap.error(f"the trace layer runs on --device {args.device}: {e}")
    findings = run_repo_analysis(layers=layers, rules=rules,
                                 device=args.device)
    render = render_json if args.format == "json" else render_text
    print(render(findings))
    return gate_count(findings, strict=args.strict)
