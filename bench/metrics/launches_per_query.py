"""Kernel launches ``repro_torch.kernels.launch_counts()`` counted over the
window, per query resolved in it."""


def read(run):
    n = sum(1 for q in run["queries"] if q["in_window"])
    return run["counters"]["launches"] / n if n else None
