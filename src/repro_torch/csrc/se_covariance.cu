// SE-covariance kernel for Hopper (sm_90a): forward and gradient (K3).
//
// Replaces the TPU kernel src/repro/kernels/se_covariance/kernel.py
// (_se_cov_kernel, launched by se_cov_pallas). For n_i snippets against n_j
// snippets with pre-widened numeric ranges [lo, hi] over l dimensions:
//
//     out[a,b] = (sigma2 * prod_k g_k[a,b]) / (norm_i[a] * norm_j[b])
//     g_k      = max(II_k, 0),
//     II_k     = F(hi_i-hi_j) - F(hi_i-lo_j) - F(lo_i-hi_j) + F(lo_i-lo_j)
//     F(u; z)  = ((-0.5 z) z) exp(-(u/z)^2) - (((0.5 sqrt(pi)) z) u) erf(u/z)
//
// with z = ls[k], the closed-form SE double integral (Appendix F.1). The
// gradient pass computes, for an incoming gradient G (n_i, n_j),
//
//     grad_ls[k] = sum_{a,b} G s prod_{j!=k} g_j dg_k/dz_k,
//     s = sigma2 / (norm_i norm_j),
//     dg_k/dz_k = dII_k/dz where II_k >= 0, else 0 (torch.clamp's backward),
//     dF/dz(u; z) = -z exp(-(u/z)^2) - (0.5 sqrt(pi)) u erf(u/z),
//
// dII/dz by the same inclusion-exclusion. prod_{j!=k} is formed directly,
// never as out / g_k: g_k is ~1e-12 on equality ranges and may be 0.
//
// What bounds it on the H100: operations. Each output element evaluates
// 4 l antiderivatives, each one division, one exp and one erf in float64
// (libdevice routines of tens of instructions, all on the non-tensor FP64
// pipe: nothing here maps to the tensor cores), while it reads 4 l + 2
// numbers and writes one. At n_i = n_j = 2000, l = 3 that is 48M exp and
// 48M erf against 32 MB written (~0.01 ms at 3.35 TB/s).
//
// Design (a first kernel, simple and right):
//  * Forward: one thread per output element. A block of 8 x 32 threads
//    stages its (8, l) and (32, l) range tiles and the l lengthscales in
//    shared memory; the l loop runs in registers; a warp writes 32
//    consecutive outputs of one row. The arithmetic is written in the plain
//    PyTorch version's operation order with explicit round-to-nearest
//    intrinsics (no contraction into FMAs), so that on the card the kernel
//    can give the plain version's bits; exp and erf are CUDA's math library
//    (the functions PyTorch's own CUDA exp and erf call).
//  * Gradient: the same tiling recomputes g_k and dII_k in registers (l <=
//    MAX_L, loops fully unrolled), forms each element's l contributions,
//    reduces them over the block with a fixed warp-shuffle tree and a fixed
//    order over warps, and writes one row of l partials per block. A second
//    pass folds the partials in block order (each of 256 threads a fixed
//    stride, then a fixed tree). No float atomics: every run gives the same
//    bits.
//  * Templated on float / double (the reference takes both dtypes).
#include <cuda_runtime.h>

namespace {

constexpr int TI = 8;     // rows (i side) per block
constexpr int TJ = 32;    // columns (j side) per block = one warp
constexpr int MAX_L = 8;  // numeric dimensions the kernel takes
constexpr int FOLD_THREADS = 256;
constexpr double HALF_SQRT_PI = 0.5 * 1.7724538509055159;

__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rexp(double x) { return exp(x); }
__device__ __forceinline__ double rerf(double x) { return erf(x); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rexp(float x) { return expf(x); }
__device__ __forceinline__ float rerf(float x) { return erff(x); }

// F(u; z) and, when grad is set, dF/dz, sharing u/z, exp and erf.
template <typename T, bool grad>
__device__ __forceinline__ void antideriv(T u, T z, T c1, T c2, T* f, T* df) {
  const T r = rdiv(u, z);
  const T e = rexp(-rmul(r, r));
  const T er = rerf(r);
  *f = rsub(rmul(c1, e), rmul(rmul(c2, u), er));
  if (grad) *df = rsub(rmul(-z, e), rmul(rmul(T(HALF_SQRT_PI), u), er));
}

// II and (when grad) dII/dz for one dimension of one (a, b) pair.
template <typename T, bool grad>
__device__ __forceinline__ void integral(T a, T b, T c, T d, T z, T* ii,
                                         T* dii) {
  const T c1 = rmul(rmul(T(-0.5), z), z);
  const T c2 = rmul(T(HALF_SQRT_PI), z);
  T f0, f1, f2, f3, d0 = T(0), d1 = T(0), d2 = T(0), d3 = T(0);
  antideriv<T, grad>(rsub(b, d), z, c1, c2, &f0, &d0);
  antideriv<T, grad>(rsub(b, c), z, c1, c2, &f1, &d1);
  antideriv<T, grad>(rsub(a, d), z, c1, c2, &f2, &d2);
  antideriv<T, grad>(rsub(a, c), z, c1, c2, &f3, &d3);
  *ii = radd(rsub(rsub(f0, f1), f2), f3);
  if (grad) *dii = radd(rsub(rsub(d0, d1), d2), d3);
}

// Stage the block's range tiles and the lengthscales in shared memory.
// Rows past the edge get the unit range [0, 1] and are never written.
template <typename T>
__device__ __forceinline__ void stage(const T* lo_i, const T* hi_i,
                                      const T* lo_j, const T* hi_j,
                                      const T* ls, int ni, int nj, int l,
                                      T* a_s, T* b_s, T* c_s, T* d_s,
                                      T* z_s) {
  const int tid = threadIdx.y * TJ + threadIdx.x;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  for (int e = tid; e < TI * l; e += TI * TJ) {
    const bool in = i0 + e / l < ni;
    a_s[e] = in ? lo_i[(size_t)i0 * l + e] : T(0);
    b_s[e] = in ? hi_i[(size_t)i0 * l + e] : T(1);
  }
  for (int e = tid; e < TJ * l; e += TI * TJ) {
    const bool in = j0 + e / l < nj;
    c_s[e] = in ? lo_j[(size_t)j0 * l + e] : T(0);
    d_s[e] = in ? hi_j[(size_t)j0 * l + e] : T(1);
  }
  for (int e = tid; e < l; e += TI * TJ) z_s[e] = ls[e];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
se_cov_fwd(const T* __restrict__ lo_i, const T* __restrict__ hi_i,
           const T* __restrict__ lo_j, const T* __restrict__ hi_j,
           const T* __restrict__ ls, const T* __restrict__ norm_i,
           const T* __restrict__ norm_j, T sigma2, int ni, int nj, int l,
           T* __restrict__ out) {
  __shared__ T a_s[TI * MAX_L], b_s[TI * MAX_L];
  __shared__ T c_s[TJ * MAX_L], d_s[TJ * MAX_L], z_s[MAX_L];
  stage<T>(lo_i, hi_i, lo_j, hi_j, ls, ni, nj, l, a_s, b_s, c_s, d_s, z_s);
  const int a = blockIdx.y * TI + threadIdx.y;
  const int b = blockIdx.x * TJ + threadIdx.x;
  if (a >= ni || b >= nj) return;
  const int ra = threadIdx.y * l, rb = threadIdx.x * l;
  T acc = T(1);
  for (int k = 0; k < l; ++k) {
    T ii, unused;
    integral<T, false>(a_s[ra + k], b_s[ra + k], c_s[rb + k], d_s[rb + k],
                       z_s[k], &ii, &unused);
    // clamp(min=0) as PyTorch does it: NaN stays NaN.
    acc = rmul(acc, ii < T(0) ? T(0) : ii);
  }
  out[(size_t)a * nj + b] = rdiv(rmul(sigma2, acc),
                                 rmul(norm_i[a], norm_j[b]));
}

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
se_cov_bwd(const T* __restrict__ lo_i, const T* __restrict__ hi_i,
           const T* __restrict__ lo_j, const T* __restrict__ hi_j,
           const T* __restrict__ ls, const T* __restrict__ norm_i,
           const T* __restrict__ norm_j, T sigma2, const T* __restrict__ G,
           int ni, int nj, int l, T* __restrict__ part) {
  __shared__ T a_s[TI * MAX_L], b_s[TI * MAX_L];
  __shared__ T c_s[TJ * MAX_L], d_s[TJ * MAX_L], z_s[MAX_L];
  __shared__ T warp_s[TI][MAX_L];
  stage<T>(lo_i, hi_i, lo_j, hi_j, ls, ni, nj, l, a_s, b_s, c_s, d_s, z_s);
  const int a = blockIdx.y * TI + threadIdx.y;
  const int b = blockIdx.x * TJ + threadIdx.x;
  T contrib[MAX_L];
#pragma unroll
  for (int k = 0; k < MAX_L; ++k) contrib[k] = T(0);
  if (a < ni && b < nj) {
    const int ra = threadIdx.y * l, rb = threadIdx.x * l;
    T g[MAX_L], dg[MAX_L];
#pragma unroll
    for (int k = 0; k < MAX_L; ++k) {
      g[k] = T(1);
      dg[k] = T(0);
      if (k < l) {
        T ii, dii;
        integral<T, true>(a_s[ra + k], b_s[ra + k], c_s[rb + k], d_s[rb + k],
                          z_s[k], &ii, &dii);
        g[k] = ii < T(0) ? T(0) : ii;
        dg[k] = ii >= T(0) ? dii : T(0);
      }
    }
    const T w = G[(size_t)a * nj + b] * (sigma2 / (norm_i[a] * norm_j[b]));
#pragma unroll
    for (int k = 0; k < MAX_L; ++k) {
      if (k < l) {
        T others = T(1);
#pragma unroll
        for (int j = 0; j < MAX_L; ++j)
          if (j != k && j < l) others *= g[j];
        contrib[k] = w * others * dg[k];
      }
    }
  }
  // Fixed-order block reduction: a shuffle tree within each warp (one row
  // of the tile), then the warps in row order.
#pragma unroll
  for (int k = 0; k < MAX_L; ++k) {
    if (k < l) {
      T v = contrib[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (threadIdx.x == 0) warp_s[threadIdx.y][k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < l) {
    const int k = threadIdx.x;
    T s = T(0);
    for (int r = 0; r < TI; ++r) s += warp_s[r][k];
    part[(size_t)(blockIdx.y * gridDim.x + blockIdx.x) * l + k] = s;
  }
}

// grad_ls[k] = sum over blocks of part[block, k], in a fixed order.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
se_cov_fold(const T* __restrict__ part, int n_blocks, int l,
            T* __restrict__ grad_ls) {
  __shared__ T s[FOLD_THREADS];
  const int k = blockIdx.x;
  T v = T(0);
  for (int p = threadIdx.x; p < n_blocks; p += FOLD_THREADS)
    v += part[(size_t)p * l + k];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = FOLD_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) grad_ls[k] = s[0];
}

dim3 grid_for(int ni, int nj) {
  return dim3((nj + TJ - 1) / TJ, (ni + TI - 1) / TI);
}

template <typename T>
int fwd_launch(const T* lo_i, const T* hi_i, const T* lo_j, const T* hi_j,
               const T* ls, const T* norm_i, const T* norm_j, T sigma2,
               int ni, int nj, int l, T* out, void* stream) {
  if (l < 0 || l > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0 || nj <= 0) return 0;
  se_cov_fwd<T><<<grid_for(ni, nj), dim3(TJ, TI), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j, sigma2, ni, nj, l, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grad_launch(const T* lo_i, const T* hi_i, const T* lo_j, const T* hi_j,
                const T* ls, const T* norm_i, const T* norm_j, T sigma2,
                const T* G, int ni, int nj, int l, T* part, T* grad_ls,
                void* stream) {
  if (l < 0 || l > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0 || nj <= 0 || l == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(ni, nj);
  se_cov_bwd<T><<<grid, dim3(TJ, TI), 0, s>>>(
      lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j, sigma2, G, ni, nj, l, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  se_cov_fold<T><<<l, FOLD_THREADS, 0, s>>>(part, grid.x * grid.y, l,
                                            grad_ls);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). sigma2 is passed by value (as
// a double, rounded to float for the f32 kernels, as PyTorch rounds a
// Python scalar). Every pointer is a device pointer to contiguous data of
// one type: lo_i, hi_i (ni, l); lo_j, hi_j (nj, l); ls (l); norm_i (ni);
// norm_j (nj); out and G (ni, nj);
// part (ceil(nj/32) * ceil(ni/8), l) scratch; grad_ls (l). Kernels run on
// `stream`, nothing is allocated here, and the return value is
// cudaGetLastError() (cudaErrorInvalidValue for l > 8).
extern "C" int se_cov_launch_f64(const double* lo_i, const double* hi_i,
                                 const double* lo_j, const double* hi_j,
                                 const double* ls, const double* norm_i,
                                 const double* norm_j, double sigma2,
                                 int ni, int nj, int l, double* out,
                                 void* stream) {
  return fwd_launch<double>(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                            sigma2, ni, nj, l, out, stream);
}

extern "C" int se_cov_launch_f32(const float* lo_i, const float* hi_i,
                                 const float* lo_j, const float* hi_j,
                                 const float* ls, const float* norm_i,
                                 const float* norm_j, double sigma2,
                                 int ni, int nj, int l, float* out,
                                 void* stream) {
  return fwd_launch<float>(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                           static_cast<float>(sigma2), ni, nj, l, out,
                           stream);
}

extern "C" int se_cov_grad_launch_f64(const double* lo_i, const double* hi_i,
                                      const double* lo_j, const double* hi_j,
                                      const double* ls, const double* norm_i,
                                      const double* norm_j, double sigma2,
                                      const double* G,
                                      int ni, int nj, int l, double* part,
                                      double* grad_ls, void* stream) {
  return grad_launch<double>(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                             sigma2, G, ni, nj, l, part, grad_ls, stream);
}

extern "C" int se_cov_grad_launch_f32(const float* lo_i, const float* hi_i,
                                      const float* lo_j, const float* hi_j,
                                      const float* ls, const float* norm_i,
                                      const float* norm_j, double sigma2,
                                      const float* G, int ni, int nj, int l,
                                      float* part, float* grad_ls,
                                      void* stream) {
  return grad_launch<float>(lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                            static_cast<float>(sigma2), G, ni, nj, l, part,
                            grad_ls, stream);
}
