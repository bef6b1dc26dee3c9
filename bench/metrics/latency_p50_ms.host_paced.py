"""Median submit-to-resolution time of the window's queries (client clock).
A per-layer metric: its runs spread past what an end-to-end bound allows,
and the host paces it (clients wait on the service's engine lock)."""
import numpy as np


def read(run):
    lat = [q["latency_s"] for q in run["queries"] if q["in_window"]]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
