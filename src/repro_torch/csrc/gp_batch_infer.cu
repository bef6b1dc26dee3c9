// Fused improved-answer kernel for Hopper (sm_90a): the improve step.
//
// Replaces the TPU kernel src/repro/kernels/gp_batch_infer/kernel.py
// (_gp_kernel, launched by gp_batch_infer_pallas). For Q new snippets
// against a synopsis of C past snippets:
//
//     gamma2[q] = max(kappa2[q] - sum_c (K Sinv)[q,c] * K[q,c], 1e-30)
//     prior[q]  = mu[q] + sum_c K[q,c] * alpha[c]
//     theta[q]  = (rawb·prior + gamma2·rawt) / (rawb + gamma2)   (Eq. 12)
//     beta2[q]  = rawb·gamma2 / (rawb + gamma2)
//     rawb <= 0: theta = rawt, beta2 = 0 (exact raw answer)
//
// What bounds it on the H100: 2·Q·C^2 multiply-adds against 8·C^2 bytes of
// Sinv (f64; 32 MB at C = 2000). At the serving shape (Q = 8) the bytes
// bound it; at larger Q the FP64 (or FP32) operations do.
//
// Design (a first kernel, simple and right; no wgmma/TMA yet):
//  * Pass 1: block (j, i) computes the (32 x 32) tile (K Sinv)[rows i, cols j]
//    with K and Sinv staged through shared memory in 32-deep slices of C,
//    multiplies it elementwise by K[rows i, cols j] and reduces each row
//    over the 32 columns with a fixed warp-shuffle tree. It writes that
//    column tile's partial row sum, and the tile's partial K·alpha, to
//    scratch[j, q]. KΣ⁻¹ is the kernel's own work (no library matmul).
//  * Pass 2: one thread per q sums the column tiles in ascending order and
//    applies the floor and the Eq. 12 blend epilogue, exactly as the TPU
//    kernel's _finalize does. No atomics: every run gives the same bits.
//  * Templated on float / double: float64 is the engine's default, float32
//    the reference kernel's precision (use_kernels=True).
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;  // rows (new snippets) per block
constexpr int TC = 32;  // Sinv columns per block (= warp width)
constexpr int TK = 32;  // depth of one shared-memory slice of C
constexpr int ROWS_PER_THREAD = 4;  // blockDim = (32, TQ / 4)

template <typename T>
__global__ void gp_partials(const T* __restrict__ K, const T* __restrict__ S,
                            const T* __restrict__ alpha, int Q, int C,
                            T* __restrict__ part_g, T* __restrict__ part_t) {
  __shared__ T k_s[TQ][TK + 1];
  __shared__ T s_s[TK][TC];
  const int tx = threadIdx.x;  // column within the tile (one warp = one row group)
  const int ty = threadIdx.y;  // 0 .. TQ/ROWS_PER_THREAD - 1
  constexpr int RSTEP = TQ / ROWS_PER_THREAD;
  const int col = blockIdx.x * TC + tx;
  const int row0 = blockIdx.y * TQ;

  T acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = T(0);

  for (int k0 = 0; k0 < C; k0 += TK) {
    for (int r = ty; r < TQ; r += RSTEP) {
      const int row = row0 + r, k = k0 + tx;
      k_s[r][tx] = (row < Q && k < C) ? K[(size_t)row * C + k] : T(0);
    }
    for (int r = ty; r < TK; r += RSTEP) {
      const int k = k0 + r;
      s_s[r][tx] = (k < C && col < C) ? S[(size_t)k * C + col] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const T s = s_s[kk][tx];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        acc[r] = fma(k_s[ty + r * RSTEP][kk], s, acc[r]);
    }
    __syncthreads();
  }

  const T a = col < C ? alpha[col] : T(0);
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int row = row0 + ty + r * RSTEP;
    const T kv = (row < Q && col < C) ? K[(size_t)row * C + col] : T(0);
    T g = acc[r] * kv;
    T t = kv * a;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g += __shfl_down_sync(0xffffffffu, g, off);
      t += __shfl_down_sync(0xffffffffu, t, off);
    }
    if (tx == 0 && row < Q) {
      part_g[(size_t)blockIdx.x * Q + row] = g;
      part_t[(size_t)blockIdx.x * Q + row] = t;
    }
  }
}

template <typename T>
__global__ void gp_finalize(const T* __restrict__ part_g,
                            const T* __restrict__ part_t, int n_tiles, int Q,
                            const T* __restrict__ kappa2,
                            const T* __restrict__ mu,
                            const T* __restrict__ rawt,
                            const T* __restrict__ rawb, T* __restrict__ theta,
                            T* __restrict__ beta2, T* __restrict__ gamma2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  T g = T(0), t = T(0);
  for (int j = 0; j < n_tiles; ++j) {
    g += part_g[(size_t)j * Q + q];
    t += part_t[(size_t)j * Q + q];
  }
  const T gam = max(kappa2[q] - g, T(1e-30));
  const T prior = mu[q] + t;
  const T rb = rawb[q], rt = rawt[q];
  const T denom = rb + gam;
  const bool exact = rb <= T(0);
  theta[q] = exact ? rt : (rb * prior + gam * rt) / denom;
  beta2[q] = exact ? T(0) : rb * gam / denom;
  gamma2[q] = gam;
}

template <typename T>
int gp_launch(const T* K, const T* S, const T* alpha, const T* kappa2,
              const T* mu, const T* rawt, const T* rawb, int Q, int C,
              T* part_g, T* part_t, T* theta, T* beta2, T* gamma2,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  const int n_tiles = C > 0 ? (C + TC - 1) / TC : 0;
  if (n_tiles > 0) {
    dim3 grid(n_tiles, (Q + TQ - 1) / TQ);
    dim3 block(TC, TQ / ROWS_PER_THREAD);
    gp_partials<T><<<grid, block, 0, s>>>(K, S, alpha, Q, C, part_g, part_t);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gp_finalize<T><<<(Q + 127) / 128, 128, 0, s>>>(
      part_g, part_t, n_tiles, Q, kappa2, mu, rawt, rawb, theta, beta2,
      gamma2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Both passes run on `stream`;
// nothing is allocated here; the return value is cudaGetLastError().
// part_g, part_t: (ceil(C/32), Q) scratch of the same type.
extern "C" int gp_launch_f64(const double* K, const double* S,
                             const double* alpha, const double* kappa2,
                             const double* mu, const double* rawt,
                             const double* rawb, int Q, int C, double* part_g,
                             double* part_t, double* theta, double* beta2,
                             double* gamma2, void* stream) {
  return gp_launch<double>(K, S, alpha, kappa2, mu, rawt, rawb, Q, C, part_g,
                           part_t, theta, beta2, gamma2, stream);
}

extern "C" int gp_launch_f32(const float* K, const float* S,
                             const float* alpha, const float* kappa2,
                             const float* mu, const float* rawt,
                             const float* rawb, int Q, int C, float* part_g,
                             float* part_t, float* theta, float* beta2,
                             float* gamma2, void* stream) {
  return gp_launch<float>(K, S, alpha, kappa2, mu, rawt, rawb, Q, C, part_g,
                          part_t, theta, beta2, gamma2, stream);
}
