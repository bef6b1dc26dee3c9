"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity), at the full 700 W power limit. A share of a roofline is stated
against these, with the card's power limit beside it.

float64 reaches 67 TFLOP/s only through the DMMA tensor cores; work that
cannot use them (K3's divisions, exp and erf) is bounded by the non-tensor
float64 rate, 34 TFLOP/s.
"""
HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float64": 67e12, "float64_simt": 34e12, "float32": 67e12}


def least_seconds(n_bytes: float, n_ops: float, rate: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FLOPS[rate])
