"""Synchronised time in ``SynopsisStore.improve_groups`` (waiting on the
ingest it drains included) per query that the traced phase's flushes
ran."""
from bench.trace import in_traced


def read(run):
    spans = run.get("spans")
    if not spans:
        return None
    n = sum(f[5]["queries"] for f in in_traced(spans, run, "flush"))
    if not n:
        return None
    return 1e3 * sum(x[3] - x[2] for x in in_traced(spans, run,
                                                    "improve")) / n
