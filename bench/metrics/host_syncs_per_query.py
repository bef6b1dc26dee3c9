"""Copies from the device to the host, each of which waits for the device
(the program's ``host_copy.count`` counter over the window), per query
resolved in the window."""
from bench.program_trace import per_query, program


def read(run):
    prog = program(run)
    if prog is None:
        return None
    return per_query(run, prog["counters"].get("host_copy.count", 0))
