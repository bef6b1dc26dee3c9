"""Queries resolved in the window over the window's seconds (host clock)."""


def read(run):
    n = sum(1 for q in run["queries"] if q["in_window"])
    return n / run["window_s"] if n else None
