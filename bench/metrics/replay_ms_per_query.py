"""Self time of host replay (the program's ``replay.query`` spans less the
``scan.block``, ``replay.improve`` and ``replay.record`` spans inside
them: estimates, ``assemble_results``, the stop test), in ms per query
resolved in the window."""
from bench.program_trace import in_window, per_query, program, self_seconds

TAKEN_OUT = ("scan.block", "replay.improve", "replay.record")


def read(run):
    if program(run) is None:
        return None
    spent = self_seconds(run, in_window(run, "replay.query"), TAKEN_OUT)
    return per_query(run, spent, 1e3)
