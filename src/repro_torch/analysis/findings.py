"""Structured findings: what every analysis rule emits.

A ``Finding`` is one violation (or inventory note) with a stable rule id, a
severity, a location (``file:line`` for AST rules, a program name for trace
rules), a human message and a fix hint. Severities:

``error``  -- a broken contract; always fails the gate.
``warn``   -- a suspicious state that needs an explicit allowlist entry;
              fails only under ``--strict`` (the CI mode).
``info``   -- inventory (e.g. idle modules with a recorded keep-reason);
              never fails.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence

ERROR = "error"
WARN = "warn"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARN: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # stable rule id, e.g. "T001"
    severity: str  # ERROR | WARN | INFO
    location: str  # "path/to/file.py:42" or "program:masked_tile_fold"
    message: str  # what is wrong, concretely
    hint: str = ""  # how to fix it

    def __post_init__(self):
        if self.severity not in _SEVERITY_ORDER:
            raise ValueError(f"unknown severity {self.severity!r}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    return sorted(
        findings,
        key=lambda f: (_SEVERITY_ORDER[f.severity], f.rule, f.location),
    )


def gate_count(findings: Sequence[Finding], strict: bool = True) -> int:
    """Number of findings that fail the gate (errors; + warns when strict)."""
    bad = {ERROR, WARN} if strict else {ERROR}
    return sum(1 for f in findings if f.severity in bad)


def render_text(findings: Sequence[Finding]) -> str:
    if not findings:
        return "no findings"
    lines = []
    for f in sort_findings(findings):
        lines.append(f"[{f.severity:<5}] {f.rule} {f.location}")
        lines.append(f"        {f.message}")
        if f.hint:
            lines.append(f"        fix: {f.hint}")
    counts = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    tally = ", ".join(f"{counts.get(s, 0)} {s}" for s in (ERROR, WARN, INFO))
    lines.append(f"-- {len(findings)} finding(s): {tally}")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps([f.as_dict() for f in sort_findings(findings)], indent=1)
