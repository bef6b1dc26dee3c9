"""SE-covariance kernel (K3): the numeric factor of the GP covariance, and
its gradient with respect to the lengthscales."""
from repro_torch.kernels.se_covariance.ops import se_cov_grad, se_cov_matrix
from repro_torch.kernels.se_covariance.ref import (
    se_cov_grad_ref,
    se_cov_matrix_ref,
)

__all__ = ["se_cov_grad", "se_cov_grad_ref", "se_cov_matrix",
           "se_cov_matrix_ref"]
