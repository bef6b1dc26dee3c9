"""Device time of the kernels launched inside the program's ``scan.block``
spans, per program ``service.flush`` the traced phase's profile holds
whole (``bench.program_trace.reduce_annotated``: kernels found by the
spans' profiler annotations, no clock offset)."""
from bench.program_trace import program


def read(run):
    prog = program(run)
    trace = prog and prog.get("trace")
    if not trace or not trace["flushes"]:
        return None
    scan = trace["device_s_by_span"].get("scan.block", 0.0)
    return 1e3 * scan / trace["flushes"]
