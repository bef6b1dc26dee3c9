"""Roofline terms of one NVIDIA H100 SXM card (the reference's
``repro.launch.roofline``, whose constants are a TPU's).

    compute term    = FLOPs / 989 TFLOP/s (dense bf16)
    memory term     = bytes / 3.35 TB/s (HBM3)
    collective term = wire_bytes / 900 GB/s (NVLink 4, per card)

``combine_costs`` assembles a step's totals from per-device cost dicts as
``step_cost + sum_probes multiplier x probe_cost`` (the reference's probes
re-compile one scanned layer group; their port comes with
``launch/hlo_analysis.py``). ``model_flops`` is the reference's, unchanged.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12  # H100 SXM data sheet: dense bf16 FLOP/s
HBM_BW = 3.35e12  # H100 SXM data sheet: HBM3 bytes/s
ICI_BW = 900e9  # H100 SXM data sheet: NVLink 4 bytes/s per card


def combine_costs(step_cost: Dict, probe_costs) -> Dict[str, float]:
    flops = step_cost.get("flops", 0.0)
    byts = step_cost.get("bytes accessed", 0.0)
    for mult, cost in probe_costs:
        flops += mult * cost.get("flops", 0.0)
        byts += mult * cost.get("bytes accessed", 0.0)
    return {"flops_per_device": float(flops), "bytes_per_device": float(byts)}


def roofline(flops_per_device: float, bytes_per_device: float,
             wire_bytes_per_device: float) -> Dict[str, float]:
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update({
        "dominant": dom,
        "step_time_lower_bound_s": bound,
        # fraction of the bound the compute term occupies = roofline fraction
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
    })
    return terms


def model_flops(cfg, kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS (all devices): 6·N_active·D train; 2·N_active·tokens decode."""
    n_act = cfg.n_active_params
    if kind == "train":
        return 6.0 * n_act * seq * batch
    if kind == "prefill":
        return 2.0 * n_act * seq * batch
    return 2.0 * n_act * batch  # decode: one token per sequence
