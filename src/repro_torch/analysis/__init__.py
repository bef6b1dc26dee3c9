"""Static analysis of the port's source tree and its scan-plane programs.

Both layers of the reference's checker, one CLI (``python -m
repro_torch.analysis --strict [--device cpu]``):

- the AST layer (``ast_rules``, rules A001-A008), retargeted at
  ``src/repro_torch``: host-only Python over the source files, importing
  none of the modules it checks but the fault registry that A003 reads
  (``repro_torch.ft.faults.POINTS``);
- the trace layer (``programs``, ``trace_rules``, rules T001-T007): the
  scan plane's programs run once each on a device under a recorder of
  their aten ops, and the rules read the records. It imports torch and
  the modules it runs only when a trace rule runs.
"""
from repro_torch.analysis.cli import run_repo_analysis, violation_count
from repro_torch.analysis.findings import (ERROR, INFO, WARN, Finding,
                                           gate_count, render_json,
                                           render_text, sort_findings)

__all__ = [
    "ERROR", "INFO", "WARN", "Finding", "gate_count", "render_json",
    "render_text", "sort_findings", "run_repo_analysis", "violation_count",
]
