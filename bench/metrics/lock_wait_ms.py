"""Time a window query's client spent waiting for the service's engine
lock inside ``Ticket.result()`` (the program's ``service.lock_wait`` spans
with ``caller=result``), in ms per query resolved in the window."""
from bench.program_trace import END, START, in_window, per_query, program


def read(run):
    if program(run) is None:
        return None
    waits = in_window(run, "service.lock_wait", caller="result")
    return per_query(run, sum(s[END] - s[START] for s in waits), 1e3)
