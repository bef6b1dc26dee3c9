"""Host time of group discovery (the program's ``plan.discover`` spans:
the first-batch probe, its mask copied to the host, the distinct groups),
in ms per non-empty flush of the window."""
from bench.program_trace import END, START, in_window, per_flush, program


def read(run):
    if program(run) is None:
        return None
    spans = in_window(run, "plan.discover")
    return per_flush(run, sum(s[END] - s[START] for s in spans))
