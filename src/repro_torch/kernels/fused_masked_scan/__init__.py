"""Fused masked-scan kernel (K1), the scan of every sample batch, and its
aggregation-only sibling (K4), the fold of the sharded placement's mask."""
from repro_torch.kernels.fused_masked_scan.ops import (
    eval_partials_fused,
    fused_masked_scan,
    masked_partials,
    masked_partials_fused,
)
from repro_torch.kernels.fused_masked_scan.ref import (
    fused_masked_scan_ref,
    masked_partials_ref,
)

__all__ = ["eval_partials_fused", "fused_masked_scan", "fused_masked_scan_ref",
           "masked_partials", "masked_partials_fused", "masked_partials_ref"]
