"""Mean queries a flush ran, over the flushes that began and ended in the
window (the benchmark's spy on ``AqpService._execute_slice``; host clock,
nothing synchronised)."""


def read(run):
    t0, t1 = run["window"]
    n = [k for t, e, k in run["flushes"] if t >= t0 and e <= t1]
    return sum(n) / len(n) if n else None
