"""Synchronised time in ``ScanPlacement.eval_block`` per flush of the
traced phase."""
from bench.trace import in_traced


def read(run):
    spans = run.get("spans")
    if not spans:
        return None
    f = len(in_traced(spans, run, "flush"))
    s = sum(x[3] - x[2] for x in in_traced(spans, run, "scan"))
    return 1e3 * s / f if f else None
