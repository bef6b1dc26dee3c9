"""Range-mask aggregation kernel (K5): range compares times a precomputed
(T, Q) mask, folded against a payload, in float32. The scan placement runs
it when handed ``eval_partials_kernel`` as its evaluator."""
from repro_torch.kernels.range_mask_agg.ops import (
    eval_partials_kernel,
    range_mask_agg,
)
from repro_torch.kernels.range_mask_agg.ref import range_mask_agg_ref

__all__ = ["eval_partials_kernel", "range_mask_agg", "range_mask_agg_ref"]
