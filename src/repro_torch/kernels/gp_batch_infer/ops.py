"""Public wrapper of the fused improved-answer kernel (Eq. 11/12).

``gp_batch_infer`` computes in ``dtype``: float64 (the engine's default,
``use_kernels=False``) or float32 (the reference kernel's precision,
``use_kernels=True``). On CUDA tensors it launches
``csrc/gp_batch_infer.cu`` instantiated for that type; on CPU tensors it
runs the plain version (``ref.gp_batch_infer_ref``) in that type. Anything
else raises. Inputs are cast to ``dtype``; outputs come back in ``dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_cuda_error, check_tensor, load
from repro_torch.kernels.gp_batch_infer.ref import gp_batch_infer_ref

GP_TILE_C = 32  # Σ⁻¹ column tile of the kernel's first pass (see the .cu)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 2 + [_P] * 5 + [_P]
_ENTRY = {torch.float64: "gp_launch_f64", torch.float32: "gp_launch_f32"}


def _entry(dtype):
    fn = getattr(load("gp_batch_infer"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def gp_batch_infer(k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta,
                   raw_beta2, dtype=torch.float64):
    """(theta_dd, beta2_dd, gamma2) for Q new snippets against C past ones.

    k_mat (Q,C); sigma_inv (C,C); alpha (C,); kappa2, mu_new, raw_theta,
    raw_beta2 (Q,).
    """
    if dtype not in _ENTRY:
        raise TypeError(f"gp_batch_infer computes in float64 or float32, "
                        f"not {dtype}")
    args = [a.to(dtype) for a in (k_mat, sigma_inv, alpha, kappa2, mu_new,
                                  raw_theta, raw_beta2)]
    dev = k_mat.device
    if dev.type == "cpu":
        return gp_batch_infer_ref(*args)
    if dev.type != "cuda":
        raise ValueError(f"gp_batch_infer: unsupported device {dev}")
    k_mat, sigma_inv, alpha, kappa2, mu_new, raw_theta, raw_beta2 = args
    q_n, c_n = k_mat.shape
    check_tensor(k_mat, "k_mat", dtype, (q_n, c_n), dev)
    check_tensor(sigma_inv, "sigma_inv", dtype, (c_n, c_n), dev)
    check_tensor(alpha, "alpha", dtype, (c_n,), dev)
    for name, v in (("kappa2", kappa2), ("mu_new", mu_new),
                    ("raw_theta", raw_theta), ("raw_beta2", raw_beta2)):
        check_tensor(v, name, dtype, (q_n,), dev)
    theta, beta2, gamma2 = (torch.empty((q_n,), dtype=dtype, device=dev)
                            for _ in range(3))
    if q_n == 0:
        return theta, beta2, gamma2
    n_tiles = -(-c_n // GP_TILE_C)
    part = torch.empty((2, max(n_tiles, 1), q_n), dtype=dtype, device=dev)
    err = _entry(dtype)(
        k_mat.data_ptr(), sigma_inv.data_ptr(), alpha.data_ptr(),
        kappa2.data_ptr(), mu_new.data_ptr(), raw_theta.data_ptr(),
        raw_beta2.data_ptr(), q_n, c_n,
        part[0].data_ptr(), part[1].data_ptr(),
        theta.data_ptr(), beta2.data_ptr(), gamma2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "gp_batch_infer")
    gp_batch_infer.launches += 1
    return theta, beta2, gamma2


gp_batch_infer.launches = 0
