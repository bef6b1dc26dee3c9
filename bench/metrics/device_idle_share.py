"""Percent of the traced window in which no operation ran on the device
(one minus the union of device activity, from ``torch.profiler``)."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
