"""Static analysis of the port's source tree.

The AST layer of the reference's checker (``ast_rules``, rules A001-A008),
retargeted at ``src/repro_torch``; one CLI (``python -m repro_torch.analysis
--strict``). Host-only Python over the source files: it imports none of
the modules it checks but the fault registry that A003 reads
(``repro_torch.ft.faults.POINTS``).
"""
from repro_torch.analysis.cli import run_repo_analysis, violation_count
from repro_torch.analysis.findings import (ERROR, INFO, WARN, Finding,
                                           gate_count, render_json,
                                           render_text, sort_findings)

__all__ = [
    "ERROR", "INFO", "WARN", "Finding", "gate_count", "render_json",
    "render_text", "sort_findings", "run_repo_analysis", "violation_count",
]
