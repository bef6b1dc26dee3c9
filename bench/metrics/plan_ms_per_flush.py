"""Self time of planning (the program's ``plan`` spans, from
``plan_workload`` through the two ``PhysicalPlan``s, less group discovery
and any other span inside them), in ms per non-empty flush of the
window."""
from bench.program_trace import in_window, per_flush, program, self_seconds


def read(run):
    if program(run) is None:
        return None
    return per_flush(run, self_seconds(run, in_window(run, "plan")))
