"""Fused improved-answer kernel (K2): the improve step (Eq. 11/12)."""
from repro_torch.kernels.gp_batch_infer.ops import gp_batch_infer
from repro_torch.kernels.gp_batch_infer.ref import gp_batch_infer_ref

__all__ = ["gp_batch_infer", "gp_batch_infer_ref"]
