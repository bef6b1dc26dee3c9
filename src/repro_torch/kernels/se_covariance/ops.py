"""Public wrappers of the SE-covariance kernel (K3): the forward, its Gram
form, the forward with saved derivatives, and the lengthscale gradient.

``se_cov_matrix(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j)`` keeps
the reference's signature and returns the (n_i, n_j) matrix
``sigma2 · ∏_k max(II_k, 0) / (norm_i · norm_j)`` in the dtype of ``lo_i``
(float64 or float32; every input is cast to it). There is no padding
contract: any n_i, n_j. ``se_cov_gram(lo, hi, ls, sigma2, norm)`` is the
same function of one batch against itself (``se_cov_matrix(lo, hi, lo, hi,
ls, sigma2, norm, norm)``); its kernel evaluates each symmetric pair's
antiderivatives once and gives the general kernel's bits.

- On a CPU tensor both run the plain version (``ref.se_cov_matrix_ref``),
  which autograd differentiates directly.
- On a CUDA tensor they run ``_SECovariance``, a ``torch.autograd.Function``
  whose forward launches ``csrc/se_covariance.cu``'s general or Gram
  kernel. When ``ls`` requires a gradient and grad mode is on, that launch
  also writes the derivatives ``D`` (l, n_i, n_j), ``D_k = sigma2 ∏_{j≠k}
  g_j · dg_k / (norm_i norm_j)``; the Function keeps them for its backward,
  which launches the reduction ``grad_ls[k] = Σ G ∘ D_k``. Only ``ls`` may
  require a gradient there: the kernels have no gradient for the ranges,
  the norms or ``sigma2``, so asking for one raises
  ``NotImplementedError``. They take any number of numeric dimensions:
  up to ``SE_MAX_L`` the kernels are templated on it, above it the kernels
  for any width run (a Gram matrix on tiles of ``SE_ANY_TILE``, each pair
  once; no scratch beyond the outputs). A missing ``nvcc``, a failed build
  or a launch error raises.

``se_cov_derivs(...)`` returns ``(K, D)`` from the general kernel with
derivatives, ``se_cov_gram_derivs(lo, hi, ls, sigma2, norm)`` the same
through the Gram kernel (``ref.se_cov_derivs_ref`` on a CPU tensor). ``se_cov_grad(...,
grad_out)`` is the gradient with respect to ``ls`` of ``sum(grad_out ·
se_cov_matrix(...))``: on a CUDA tensor the general forward with
derivatives into scratch, then the reduction (fixed-order two-pass, bitwise
the same on every run and the same as the autograd path); autograd of the
plain version on a CPU tensor.

Launch counts, one integer a kernel: ``se_cov_matrix.launches`` (the
general forward), ``se_cov_gram.launches`` (the Gram forward),
``se_cov_derivs.launches`` (forwards of either kind that wrote
derivatives) and ``se_cov_grad.launches`` (the reduction: every backward).
``launch_shapes`` counts the forwards' launches by (route, n_i, n_j, l),
route one of ``general``, ``general+derivs``, ``gram`` and
``gram+derivs`` (``reset_launch_counts`` empties it too).
``se_cov_plan`` is the Gram kernel's launch plan, which the CPU tests check
and the card holds against the built library's.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import (
    check_cuda_error,
    check_tensor,
    count_launch,
    load,
)
from repro_torch.kernels.se_covariance.ref import (
    se_cov_derivs_ref,
    se_cov_grad_ref,
    se_cov_matrix_ref,
)

SE_GRAM_TILE = 32  # side of the Gram kernel's square tiles (see the .cu)
SE_GRAM_ROWS = 8  # thread rows of a Gram block (SE_GRAM_TILE / 8 rows each)
SE_REDUCE_CHUNK = 2048  # elements one block of the reduction sums
SE_MAX_L = 8  # widest l with kernels of its own; wider l run the any-l ones
SE_ANY_TILE = 8  # the any-l Gram kernel: tile side and thread rows (a pair a thread)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_LL = ctypes.c_longlong
_ENTRIES = {
    "se_cov_launch": [_P] * 7 + [_D] + [_I] * 3 + [_P] * 3,
    "se_cov_gram_launch": [_P] * 4 + [_D] + [_I] * 2 + [_P] * 3,
    "se_cov_reduce_launch": [_P, _P, _LL, _I, _P, _P, _P],
    "se_cov_probe": [_P, _D, _I, _P, _P, _P],
    "se_cov_plan": [_I, _I, _P, _P],
}
_SUFFIX = {torch.float64: "_f64", torch.float32: "_f32"}
launch_shapes = collections.Counter()  # (route, n_i, n_j, l): launches


def _entry(name, dtype=None):
    full = name + (_SUFFIX[dtype] if dtype is not None else "")
    fn = getattr(load("se_covariance"), full)
    if fn.argtypes is None:
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
    return fn


class SePlan(NamedTuple):
    """The Gram kernel's grid over the upper triangle of square tiles, and
    the reduction's block size. Up to ``SE_MAX_L`` dimensions the tiles are
    ``SE_GRAM_TILE`` square with ``SE_GRAM_ROWS`` thread rows; above it the
    kernel for any width takes ``SE_ANY_TILE`` square tiles, a pair a
    thread."""

    n: int
    tile: int
    rows: int  # thread rows of a block
    n_tiles: int
    blocks: int
    reduce_chunk: int
    max_l: int  # widest l with kernels of its own

    def tiles(self, block):
        """(ti, tj), ti <= tj: the tile block ``block`` covers (row by row
        through the upper triangle, as ``gram_tile`` in the .cu)."""
        i, start = 0, 0
        while block >= start + (self.n_tiles - i):
            start += self.n_tiles - i
            i += 1
        return i, i + (block - start)

    def writes(self, block):
        """What block ``block`` writes, as arrays (row, col, a, b): entry
        (row, col) is formed from the antiderivatives of the pair (a, b)
        (i side a, j side b). A diagonal block writes its tile's (a, b)
        entries; an off-diagonal one writes (a, b) and, from the same
        values, (b, a). Entries past n are not written."""
        ti, tj = self.tiles(block)
        al, bl = np.meshgrid(np.arange(self.tile), np.arange(self.tile),
                             indexing="ij")
        a, b = (ti * self.tile + al).ravel(), (tj * self.tile + bl).ravel()
        keep = (a < self.n) & (b < self.n)
        a, b = a[keep], b[keep]
        if ti == tj:
            return a, b, a, b
        return (np.concatenate([a, b]), np.concatenate([b, a]),
                np.concatenate([a, a]), np.concatenate([b, b]))


def se_cov_plan(n, l=3):
    """K3's launch plan for a Gram matrix of n snippets over l dims."""
    tile, rows = ((SE_GRAM_TILE, SE_GRAM_ROWS) if l <= SE_MAX_L
                  else (SE_ANY_TILE, SE_ANY_TILE))
    t = -(-n // tile)
    return SePlan(n, tile, rows, t, t * (t + 1) // 2, SE_REDUCE_CHUNK,
                  SE_MAX_L)


def se_cov_plan_of_library(n, l=3):
    """``se_cov_plan`` of the built library (the card's build): ((tile,
    rows, tiles a side, blocks, reduction chunk, widest templated l),
    [(ti, tj) of every block])."""
    out = (ctypes.c_int * 6)()
    _entry("se_cov_plan")(n, l, out, None)
    tiles = (ctypes.c_int * max(2 * out[3], 1))()
    _entry("se_cov_plan")(n, l, out, tiles)
    return tuple(out), [(tiles[2 * b], tiles[2 * b + 1])
                        for b in range(out[3])]


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
    for name, t, shape in (("lo_i", lo_i, (n_i, l)), ("hi_i", hi_i, (n_i, l)),
                           ("lo_j", lo_j, (n_j, l)), ("hi_j", hi_j, (n_j, l)),
                           ("ls", ls, (l,)), ("norm_i", norm_i, (n_i,)),
                           ("norm_j", norm_j, (n_j,))):
        check_tensor(t, name, dt, shape, dev)
    return n_i, n_j, l


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _outputs(n_i, n_j, l, like, derivs):
    """(out, D or None)."""
    def new(*shape):
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    return new(n_i, n_j), new(l, n_i, n_j) if derivs else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_general(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j, *,
                    derivs):
    """The general kernel: (out, D or None)."""
    n_i, n_j, l = _checked(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j)
    out, d = _outputs(n_i, n_j, l, lo_i, derivs)
    if n_i == 0 or n_j == 0:
        return out, d
    err = _entry("se_cov_launch", lo_i.dtype)(
        lo_i.data_ptr(), hi_i.data_ptr(), lo_j.data_ptr(), hi_j.data_ptr(),
        ls.data_ptr(), norm_i.data_ptr(), norm_j.data_ptr(), sigma2,
        n_i, n_j, l, out.data_ptr(), _ptr(d), _stream(lo_i.device))
    check_cuda_error(err, "se_cov_matrix")
    count_launch(se_cov_matrix, *((se_cov_derivs,) if derivs else ()),
                 shapes=launch_shapes,
                 key=("general+derivs" if derivs else "general", n_i, n_j, l))
    return out, d


def _launch_gram(lo, hi, ls, sigma2, norm, *, derivs):
    """The Gram kernel: (out, D or None) of the batch against itself."""
    n, _, l = _checked(lo, hi, lo, hi, ls, norm, norm)
    out, d = _outputs(n, n, l, lo, derivs)
    if n == 0:
        return out, d
    err = _entry("se_cov_gram_launch", lo.dtype)(
        lo.data_ptr(), hi.data_ptr(), ls.data_ptr(), norm.data_ptr(), sigma2,
        n, l, out.data_ptr(), _ptr(d), _stream(lo.device))
    check_cuda_error(err, "se_cov_gram")
    count_launch(se_cov_gram, *((se_cov_derivs,) if derivs else ()),
                 shapes=launch_shapes,
                 key=("gram+derivs" if derivs else "gram", n, n, l))
    return out, d


def _launch_reduce(grad_out, d):
    """(l,): Σ_{a,b} grad_out[a, b] · d[k, a, b], in a fixed order."""
    l = d.shape[0]
    check_tensor(grad_out, "grad_out", d.dtype, d.shape[1:], d.device)
    m = grad_out.numel()
    if m == 0 or l == 0:
        return torch.zeros((l,), dtype=d.dtype, device=d.device)
    part = torch.empty((-(-m // SE_REDUCE_CHUNK), l), dtype=d.dtype,
                       device=d.device)
    grad = torch.empty((l,), dtype=d.dtype, device=d.device)
    err = _entry("se_cov_reduce_launch", d.dtype)(
        grad_out.data_ptr(), d.data_ptr(), m, l, part.data_ptr(),
        grad.data_ptr(), _stream(d.device))
    check_cuda_error(err, "se_cov_grad")
    count_launch(se_cov_grad)
    return grad


class _SECovariance(torch.autograd.Function):
    """A forward kernel (``launch``: general or Gram), with the reduction
    over the derivatives it saved as its backward (the gradient for ``ls``,
    the argument at ``ls_at``, only; ``sigma2`` is a number)."""

    @staticmethod
    def forward(ctx, launch, ls_at, derivs, *args):
        out, d = launch(*args, derivs=derivs)
        ctx.ls_at, ctx.n_args = ls_at, len(args)
        if d is not None:
            ctx.save_for_backward(d)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        grads = [None] * (3 + ctx.n_args)
        if ctx.needs_input_grad[3 + ctx.ls_at]:
            (d,) = ctx.saved_tensors
            grads[3 + ctx.ls_at] = _launch_reduce(
                grad_out.to(d.dtype).contiguous(), d)
        return tuple(grads)


def _device_args(dt, tensors):
    """Cast to the compute dtype and make contiguous."""
    return [t.contiguous() for t in _cast(dt, tensors)]


def _refuse_other_gradients(named):
    wants = [n for n, t in named
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if wants:
        raise NotImplementedError(
            "se_cov_matrix on the card differentiates with respect to ls "
            f"only; {', '.join(wants)} require a gradient")


def _wants_derivs(ls):
    return torch.is_grad_enabled() and ls.requires_grad


def _cpu_args(lo_i, sigma2, tensors):
    dt = _compute_dtype(lo_i)
    if isinstance(sigma2, torch.Tensor):
        sigma2 = sigma2.to(dt)
    return sigma2, _cast(dt, tensors)


def se_cov_matrix(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """sigma2 · ∏_k II_k / (norm_i norm_j) as an (n_i, n_j) matrix.

    lo/hi: (n, l) pre-widened ranges; ls: (l,); sigma2: a number or a
    0-d/1-element tensor (on the card it is read once and passed to the
    kernel by value); norm: (n,).
    """
    dev = lo_i.device
    if dev.type == "cpu":
        sigma2, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j) = _cpu_args(
            lo_i, sigma2, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j))
        return se_cov_matrix_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i,
                                 norm_j)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_matrix: unsupported device {dev}")
    _refuse_other_gradients((("lo_i", lo_i), ("hi_i", hi_i), ("lo_j", lo_j),
                             ("hi_j", hi_j), ("sigma2", sigma2),
                             ("norm_i", norm_i), ("norm_j", norm_j)))
    lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j = _device_args(
        _compute_dtype(lo_i), (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j))
    return _SECovariance.apply(_launch_general, 4, _wants_derivs(ls), lo_i,
                               hi_i, lo_j, hi_j, ls, float(sigma2), norm_i,
                               norm_j)


def se_cov_gram(lo, hi, ls, sigma2, norm):
    """``se_cov_matrix(lo, hi, lo, hi, ls, sigma2, norm, norm)``: the (n, n)
    matrix of one batch against itself, bitwise the general kernel's."""
    dev = lo.device
    if dev.type == "cpu":
        sigma2, (lo, hi, ls, norm) = _cpu_args(lo, sigma2, (lo, hi, ls, norm))
        return se_cov_matrix_ref(lo, hi, lo, hi, ls, sigma2, norm, norm)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_gram: unsupported device {dev}")
    _refuse_other_gradients((("lo", lo), ("hi", hi), ("sigma2", sigma2),
                             ("norm", norm)))
    lo, hi, ls, norm = _device_args(_compute_dtype(lo), (lo, hi, ls, norm))
    return _SECovariance.apply(_launch_gram, 2, _wants_derivs(ls), lo, hi,
                               ls, float(sigma2), norm)


def se_cov_derivs(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j):
    """(K, D): ``se_cov_matrix(...)`` (n_i, n_j) and its derivatives D (l,
    n_i, n_j), ``D_k = dK/dz_k`` taken through the clamp as torch.clamp
    takes it. No autograd."""
    dev = lo_i.device
    if dev.type == "cpu":
        sigma2, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j) = _cpu_args(
            lo_i, sigma2, (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j))
        return se_cov_derivs_ref(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i,
                                 norm_j)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_derivs: unsupported device {dev}")
    args = _device_args(_compute_dtype(lo_i),
                        (lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j))
    return _launch_general(*args[:5], float(sigma2), *args[5:], derivs=True)


def se_cov_gram_derivs(lo, hi, ls, sigma2, norm):
    """``se_cov_derivs(lo, hi, lo, hi, ls, sigma2, norm, norm)`` through the
    Gram kernel, bitwise the general kernel's. No autograd."""
    dev = lo.device
    if dev.type == "cpu":
        sigma2, (lo, hi, ls, norm) = _cpu_args(lo, sigma2, (lo, hi, ls, norm))
        return se_cov_derivs_ref(lo, hi, lo, hi, ls, sigma2, norm, norm)
    if dev.type != "cuda":
        raise ValueError(f"se_cov_gram_derivs: unsupported device {dev}")
    lo, hi, ls, norm = _device_args(_compute_dtype(lo), (lo, hi, ls, norm))
    return _launch_gram(lo, hi, ls, float(sigma2), norm, derivs=True)


def se_cov_grad(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j, grad_out):
    """(l,): d/d ls of ``sum(grad_out · se_cov_matrix(...))``."""
    dev = lo_i.device
    if dev.type == "cpu":
        sigma2, args = _cpu_args(lo_i, sigma2, (lo_i, hi_i, lo_j, hi_j, ls,
                                                norm_i, norm_j, grad_out))
        return se_cov_grad_ref(*args[:5], sigma2, *args[5:])
    if dev.type != "cuda":
        raise ValueError(f"se_cov_grad: unsupported device {dev}")
    _, d = se_cov_derivs(lo_i, hi_i, lo_j, hi_j, ls, sigma2, norm_i, norm_j)
    return _launch_reduce(grad_out.to(d.dtype).contiguous(), d)


def se_cov_probe(u, z, with_derivative=False):
    """F(u; z) (and dF/dz) at every element of the 1-D CUDA tensor ``u``,
    by the kernels' own antiderivative: the card's check that F is even bit
    for bit. Counts no launch (it is not on any path)."""
    u = u.contiguous()
    f = torch.empty_like(u)
    df = torch.empty_like(u) if with_derivative else None
    err = _entry("se_cov_probe", u.dtype)(
        u.data_ptr(), float(z), u.numel(), f.data_ptr(),
        df.data_ptr() if with_derivative else None, _stream(u.device))
    check_cuda_error(err, "se_cov_probe")
    return (f, df) if with_derivative else f


se_cov_matrix.launches = 0
se_cov_gram.launches = 0
se_cov_derivs.launches = 0
se_cov_grad.launches = 0
