"""Normal-distribution helpers used by error bounds and model validation."""
from __future__ import annotations

import math

import torch


def confidence_multiplier(delta) -> float:
    """alpha_delta: a standard normal falls within (-alpha, alpha) w.p. ``delta``.

    Section 3.4 of the paper ("confidence interval multiplier"). Computed in
    float64 on the CPU: it is a scalar that every device uses alike.
    """
    d = torch.as_tensor(float(delta), dtype=torch.float64)
    return math.sqrt(2.0) * float(torch.special.erfinv(d))
