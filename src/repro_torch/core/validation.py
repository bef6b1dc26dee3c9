"""Model validation (paper Appendix B).

The model-based answer is accepted only if the AQP raw answer lands inside the
"likely region" the model predicts for it; otherwise Verdict returns the raw
answer unchanged (this is what makes Theorem 1 hold unconditionally).

likely region: |theta_raw - theta_dd| < t with t = alpha_{delta_v} * beta_raw.
FREQ(*) additionally rejects negative model-based answers.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import FREQ
from repro_torch.utils.stats import confidence_multiplier


def validate(agg, model_theta, model_beta2, raw_theta, raw_beta2, delta_v=0.99):
    """Returns (theta_hat, beta2_hat, accepted) per snippet (batched)."""
    t = confidence_multiplier(delta_v) * torch.sqrt(torch.clamp(raw_beta2,
                                                                min=0.0))
    in_region = torch.abs(raw_theta - model_theta) <= t
    nonneg_ok = (agg != FREQ) | (model_theta >= 0.0)
    accepted = in_region & nonneg_ok
    theta = torch.where(accepted, model_theta, raw_theta)
    beta2 = torch.where(accepted, model_beta2, raw_beta2)
    return theta, beta2, accepted
