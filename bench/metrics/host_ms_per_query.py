"""Host time of the engine and plan IR a query: the synchronised flush
spans of the traced phase, less the scan, improve and record spans inside
them, over the queries those flushes ran."""
from bench.trace import in_traced

INNER = ("scan", "improve", "record")


def read(run):
    spans = run.get("spans")
    if not spans:
        return None
    flushes = in_traced(spans, run, "flush")
    inner = [s for s in spans if s[0] in INNER]
    total = queries = 0
    for f in flushes:
        kids = sum(s[3] - s[2] for s in inner
                   if s[4] == f[4] and s[2] >= f[2] and s[3] <= f[3])
        total += (f[3] - f[2]) - kids
        queries += f[5]["queries"]
    return 1e3 * total / queries if queries else None
