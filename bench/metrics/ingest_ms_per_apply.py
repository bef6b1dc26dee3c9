"""Synchronised time of one ``Synopsis._apply_add`` on the ingest thread,
in the traced phase."""
from bench.trace import in_traced


def read(run):
    spans = run.get("spans")
    if not spans:
        return None
    s = in_traced(spans, run, "ingest")
    return 1e3 * sum(x[3] - x[2] for x in s) / len(s) if s else None
