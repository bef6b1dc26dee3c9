"""Flushes that took the engine lock and found the queue empty (the
program's ``service.empty_flush`` counter over the window), per query
resolved in the window."""
from bench.program_trace import per_query, program


def read(run):
    prog = program(run)
    if prog is None:
        return None
    return per_query(run, prog["counters"].get("service.empty_flush", 0))
