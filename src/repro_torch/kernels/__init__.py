"""Hand-written CUDA kernels for the port's hot spots, and how they are built.

Each kernel package follows ``ref.py`` (the plain PyTorch version of the
kernel's function) / ``ops.py`` (the public wrapper). The CUDA sources live
in ``repro_torch/csrc/``, one ``.cu`` file per kernel with a plain C entry
point. On first use they are compiled with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the repository root and loaded with ``ctypes``.

Device rule, shared by every wrapper: a wrapper runs its plain version only
for tensors that lie on the CPU. For a CUDA tensor it launches the kernel or
raises: a missing ``nvcc``, a failed build or a launch that returns a CUDA
error is an exception, never a fallback.

Kernels:
  fused_masked_scan -- the scan: range compare + categorical membership +
                       validity + ``[m, m², 1]`` partials in one pass (f64).
  masked_partials   -- the sharded placement's fold of a gathered (T, Q)
                       mask against ``[m, m², 1]``, in the scan's own order
                       (f64; same source file as the scan).
  gp_batch_infer    -- the improve step: ``diag(K Σ⁻¹ Kᵀ)``, ``K α`` and the
                       Eq. 12 blend (f64, or f32 under ``use_kernels=True``).
  range_mask_agg    -- range compares times a precomputed (T, Q) mask,
                       folded against a payload (f32); the evaluator
                       ``eval_partials_kernel`` of the scan placement.
  se_cov_matrix     -- the numeric factor of the GP covariance: the product
                       of closed-form SE double integrals (f64 or f32), the
                       forward of every covariance build.
  se_cov_grad       -- its gradient with respect to the lengthscales (the
                       backward of the learning path's NLL); same source.

Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, which ``launch_counts`` reads and
``reset_launch_counts`` zeroes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

RANGE_EPS = 1e-12  # shared predicate-boundary epsilon (kernel == plain version)

SCAN_TILE_T = 512  # tuple-axis tile of the plain scan's fixed-order fold
SCAN_TILE_Q = 128  # snippet-axis tile (= core.types.SNIPPET_TILE serve tiles)

KERNEL_SOURCES = ("fused_masked_scan", "gp_batch_infer", "range_mask_agg",
                  "se_covariance")

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location. Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every stale kernel source, one ``nvcc`` per source, all
    started together. Returns ``{name: compiler output}``; raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    names = [n for n in names if n not in _BUILD_LOG and _stale(n)]
    if not names:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: no torn library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    _BUILD_LOG.update(logs)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
    return lib


def check_cuda_error(code: int, what: str):
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def check_tensor(t, name: str, dtype, shape, device):
    """Validate one kernel argument before its pointer is handed to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _wrappers():
    from repro_torch.kernels.fused_masked_scan import ops as fms_ops
    from repro_torch.kernels.gp_batch_infer import ops as gp_ops
    from repro_torch.kernels.range_mask_agg import ops as rma_ops
    from repro_torch.kernels.se_covariance import ops as se_ops

    return {"fused_masked_scan": fms_ops.fused_masked_scan,
            "masked_partials": fms_ops.masked_partials,
            "gp_batch_infer": gp_ops.gp_batch_infer,
            "range_mask_agg": rma_ops.range_mask_agg,
            "se_cov_matrix": se_ops.se_cov_matrix,
            "se_cov_grad": se_ops.se_cov_grad}


def launch_counts() -> Dict[str, int]:
    """``{kernel: launches}`` since the last ``reset_launch_counts``."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
