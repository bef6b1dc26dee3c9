"""Mean time a recorded batch waited in a synopsis' ingest queue before
its apply began (the program's ``ingest.queued`` spans), over the window's
batches."""
from bench.program_trace import END, START, in_window, program


def read(run):
    if program(run) is None:
        return None
    waits = in_window(run, "ingest.queued")
    if not waits:
        return None
    return 1e3 * sum(s[END] - s[START] for s in waits) / len(waits)
