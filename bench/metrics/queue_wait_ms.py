"""Mean time from a window query's submit to the start of the flush that
runs it (the benchmark's spy on ``AqpService._execute_slice``; host clock,
nothing synchronised)."""


def read(run):
    w = [q["start"] - q["submit"] for q in run["queries"]
         if q["in_window"] and q.get("start") is not None]
    return 1e3 * sum(w) / len(w) if w else None
