"""Fused masked-scan kernel (K1): the scan of every sample batch."""
from repro_torch.kernels.fused_masked_scan.ops import (
    eval_partials_fused,
    fused_masked_scan,
)
from repro_torch.kernels.fused_masked_scan.ref import fused_masked_scan_ref

__all__ = ["eval_partials_fused", "fused_masked_scan", "fused_masked_scan_ref"]
