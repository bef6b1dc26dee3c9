// Asynchronous copies into shared memory (cp.async, tracked by commit/wait
// groups) and the shared-memory opt-in, shared by the kernels redesigned
// for Hopper: K4 (fused_masked_scan.cu), K2 (gp_batch_infer.cu) and K3's
// Gram kernel (se_covariance.cu, the opt-in only).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from global to shared memory asynchronously, or
// write BYTES of zeros when `valid` is false (src-size 0: nothing is read).
// 16-byte copies bypass L1 (.cg, the only level that size allows).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid = true) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a ring depth known only at run time (n in 0..7):
// cp.async.wait_group takes an immediate.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Let `kernel` use up to `bytes` of dynamic shared memory (by default 227
// KB, the most a block may, for a kernel with no static shared memory),
// once per device: `devices` holds a bit for each device done. A refusal
// is returned and cleared from the thread's last error.
inline cudaError_t opt_in_smem(const void* kernel, uint64_t& devices,
                               int bytes = 227 * 1024) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (devices & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    devices |= bit;
  else
    cudaGetLastError();
  return e;
}

}  // namespace
