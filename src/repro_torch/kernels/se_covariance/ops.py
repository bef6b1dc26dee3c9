"""Public wrappers of the SE-covariance kernel (K3): forward and gradient.

``se_cov_matrix(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j)`` keeps
the reference's signature and returns the (n_i, n_j) matrix
``sigma2 · ∏_k max(II_k, 0) / (norm_i · norm_j)`` in the dtype of ``lo_i``
(float64 or float32; every input is cast to it). There is no padding
contract: any n_i, n_j.

- On a CPU tensor it runs the plain version (``ref.se_cov_matrix_ref``),
  which autograd differentiates directly.
- On a CUDA tensor it runs ``_SECovariance``, a ``torch.autograd.Function``
  whose forward launches ``csrc/se_covariance.cu``'s forward kernel and
  whose backward launches its gradient kernel (``se_cov_grad``). Only
  ``ls`` may require a gradient there: the kernel has no gradient for the
  ranges, the norms or ``sigma2``, so asking for one raises
  ``NotImplementedError``. The kernel takes at most ``SE_MAX_L`` numeric
  dimensions. A missing ``nvcc``, a failed build or a launch error raises.

``se_cov_grad(..., grad_out)`` is the gradient with respect to ``ls`` of
``sum(grad_out · se_cov_matrix(...))``: the gradient kernel on a CUDA
tensor (fixed-order two-pass reduction, bitwise the same on every run),
autograd of the plain version on a CPU tensor.

``se_cov_matrix.launches`` counts forward launches, ``se_cov_grad.launches``
gradient launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import check_cuda_error, check_tensor, load
from repro_torch.kernels.se_covariance.ref import (
    se_cov_grad_ref,
    se_cov_matrix_ref,
)

SE_TILE_I = 8  # rows of one block of the kernels (see the .cu)
SE_TILE_J = 32  # columns of one block
SE_MAX_L = 8  # numeric dimensions the kernels take

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_FWD = ({torch.float64: "se_cov_launch_f64", torch.float32: "se_cov_launch_f32"},
        [_P] * 7 + [_D] + [_I] * 3 + [_P] * 2)
_GRAD = ({torch.float64: "se_cov_grad_launch_f64",
          torch.float32: "se_cov_grad_launch_f32"},
         [_P] * 7 + [_D, _P] + [_I] * 3 + [_P] * 3)


def _entry(which, dtype):
    names, argtypes = which
    fn = getattr(load("se_covariance"), names[dtype])
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _compute_dtype(lo_i):
    if lo_i.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"se_cov_matrix computes in float64 or float32, not "
                        f"{lo_i.dtype}")
    return lo_i.dtype


def _cast(dtype, tensors):
    return [t.to(dtype) for t in tensors]


def _checked(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j):
    """Validate the kernels' tensor inputs (contiguous, one dtype, one
    device); returns (n_i, n_j, l)."""
    dt, dev = lo_i.dtype, lo_i.device
    n_i, l = lo_i.shape
    n_j = lo_j.shape[0]
    if l > SE_MAX_L:
        raise ValueError(f"se_cov_matrix: the kernel takes at most {SE_MAX_L}"
                         f" numeric dimensions, got {l}")
    for name, t, shape in (("lo_i", lo_i, (n_i, l)), ("hi_i", hi_i, (n_i, l)),
                           ("lo_j", lo_j, (n_j, l)), ("hi_j", hi_j, (n_j, l)),
                           ("ls", ls, (l,)), ("norm_i", norm_i, (n_i,)),
                           ("norm_j", norm_j, (n_j,))):
        check_tensor(t, name, dt, shape, dev)
    return n_i, n_j, l


def _launch_forward(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    n_i, n_j, l = _checked(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j)
    dev = lo_i.device
    out = torch.empty((n_i, n_j), dtype=lo_i.dtype, device=dev)
    if n_i == 0 or n_j == 0:
        return out
    err = _entry(_FWD, lo_i.dtype)(
        lo_i.data_ptr(), hi_i.data_ptr(), lo_j.data_ptr(), hi_j.data_ptr(),
        ls.data_ptr(), norm_i.data_ptr(), norm_j.data_ptr(), sigma2,
        n_i, n_j, l, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "se_cov_matrix")
    se_cov_matrix.launches += 1
    return out


def _launch_grad(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j,
                 grad_out):
    n_i, n_j, l = _checked(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j)
    dev = lo_i.device
    check_tensor(grad_out, "grad_out", lo_i.dtype, (n_i, n_j), dev)
    if n_i == 0 or n_j == 0 or l == 0:
        return torch.zeros((l,), dtype=lo_i.dtype, device=dev)
    n_blocks = -(-n_i // SE_TILE_I) * -(-n_j // SE_TILE_J)
    part = torch.empty((n_blocks, l), dtype=lo_i.dtype, device=dev)
    grad = torch.empty((l,), dtype=lo_i.dtype, device=dev)
    err = _entry(_GRAD, lo_i.dtype)(
        lo_i.data_ptr(), hi_i.data_ptr(), lo_j.data_ptr(), hi_j.data_ptr(),
        ls.data_ptr(), norm_i.data_ptr(), norm_j.data_ptr(), sigma2,
        grad_out.data_ptr(), n_i, n_j, l,
        part.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_cuda_error(err, "se_cov_grad")
    se_cov_grad.launches += 1
    return grad


class _SECovariance(torch.autograd.Function):
    """The forward kernel, with the gradient kernel as its backward
    (the gradient for ``ls`` only; ``sigma2`` is a number)."""

    @staticmethod
    def forward(ctx, lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
        ctx.save_for_backward(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j)
        ctx.sigma2 = sigma2
        return _launch_forward(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i,
                               norm_j)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j = ctx.saved_tensors
        grad_ls = None
        if ctx.needs_input_grad[4]:
            grad_ls = _launch_grad(lo_i, hi_i, lo_j, hi_j, ls, ctx.sigma2,
                                   norm_i, norm_j,
                                   grad_out.to(lo_i.dtype).contiguous())
        return None, None, None, None, grad_ls, None, None, None


def _device_args(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """Cast to the compute dtype and make contiguous; ``sigma2`` becomes a
    Python number, passed to the kernel by value (a tensor costs one
    device-to-host read)."""
    dt = _compute_dtype(lo_i)
    return [t.contiguous() for t in _cast(dt, (lo_i, hi_i, lo_j, hi_j, ls))
            ] + [float(sigma2)] + [t.contiguous()
                                   for t in _cast(dt, (norm_i, norm_j))]


def se_cov_matrix(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """sigma2 · ∏_k II_k / (norm_i norm_j) as an (n_i, n_j) matrix.

    lo/hi: (n, l) pre-widened ranges; ls: (l,); sigma2: a number or a
    0-d/1-element tensor; norm: (n,).
    """
    dev = lo_i.device
    if dev.type == "cpu":
        dt = _compute_dtype(lo_i)
        if isinstance(sigma2, torch.Tensor):
            sigma2 = sigma2.to(dt)
        lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j = _cast(
            dt, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j))
        return se_cov_matrix_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i,
                                 norm_j)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_matrix: unsupported device {dev}")
    named = (("lo_i", lo_i), ("hi_i", hi_i), ("lo_j", lo_j), ("hi_j", hi_j),
             ("sigma2", sigma2), ("norm_i", norm_i), ("norm_j", norm_j))
    wants = [n for n, t in named
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if wants:
        raise NotImplementedError(
            "se_cov_matrix on the card differentiates with respect to ls "
            f"only; {', '.join(wants)} require a gradient")
    return _SECovariance.apply(*_device_args(lo_i, hi_i, lo_j, hi_j, ls,
                                             sigma2, norm_i, norm_j))


def se_cov_grad(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j, grad_out):
    """(l,): d/d ls of ``sum(grad_out · se_cov_matrix(...))``."""
    dev = lo_i.device
    if dev.type == "cpu":
        dt = _compute_dtype(lo_i)
        if isinstance(sigma2, torch.Tensor):
            sigma2 = sigma2.to(dt)
        lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j, grad_out = _cast(
            dt, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j, grad_out))
        return se_cov_grad_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i,
                               norm_j, grad_out)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_grad: unsupported device {dev}")
    args = _device_args(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j)
    return _launch_grad(*args, grad_out.to(args[0].dtype).contiguous())


se_cov_matrix.launches = 0
se_cov_grad.launches = 0
