"""Megabytes copied from the device to the host (the program's
``host_copy.bytes`` counter over the window, every copy through
``repro_torch.core.types.to_numpy``), per query resolved in the window."""
from bench.program_trace import per_query, program


def read(run):
    prog = program(run)
    if prog is None:
        return None
    return per_query(run, prog["counters"].get("host_copy.bytes", 0), 1e-6)
