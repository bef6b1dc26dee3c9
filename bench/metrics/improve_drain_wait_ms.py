"""Time improve waited for the synopses' ingest before reading them (the
program's ``store.drain_wait`` spans), in ms per query resolved in the
window."""
from bench.program_trace import END, START, in_window, per_query, program


def read(run):
    if program(run) is None:
        return None
    waits = in_window(run, "store.drain_wait")
    return per_query(run, sum(s[END] - s[START] for s in waits), 1e3)
