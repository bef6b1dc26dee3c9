// SE-covariance kernels for Hopper (sm_90a): K3's forward, its Gram form,
// and the lengthscale gradient from derivatives the forward saves.
//
// Replaces the TPU kernel src/repro/kernels/se_covariance/kernel.py
// (_se_cov_kernel, launched by se_cov_pallas) and the XLA gradient of its
// function. For n_i snippets against n_j snippets with pre-widened numeric
// ranges [lo, hi] over l dimensions:
//
//     out[a,b] = (sigma2 * prod_k g_k[a,b]) / (norm_i[a] * norm_j[b])
//     g_k      = max(II_k, 0),
//     II_k     = F(hi_i-hi_j) - F(hi_i-lo_j) - F(lo_i-hi_j) + F(lo_i-lo_j)
//     F(u; z)  = ((-0.5 z) z) exp(-(u/z)^2) - (((0.5 sqrt(pi)) z) u) erf(u/z)
//
// with z = ls[k], the closed-form SE double integral (Appendix F.1). With
// derivatives on, a forward also writes, for every dimension k,
//
//     D_k[a,b] = (s prod_{j!=k} g_j) dg_k,   s = sigma2 / (norm_i norm_j),
//     dg_k = dII_k/dz where II_k >= 0, else 0 (torch.clamp's backward),
//     dF/dz(u; z) = -z exp(-(u/z)^2) - (0.5 sqrt(pi)) u erf(u/z),
//
// dII/dz by the same inclusion-exclusion (prod_{j!=k} is formed directly,
// never as out / g_k: g_k is ~1e-12 on equality ranges and may be 0), and
// the backward reduces grad_ls[k] = sum_{a,b} G[a,b] D_k[a,b].
//
// What bounds each entry point on the H100, and what the design does:
//  * The forwards (se_cov_launch_*, se_cov_gram_launch_*): operations on
//    the non-tensor FP64 pipe. Each antiderivative is a division, an exp
//    and an erf (libdevice routines of tens of FP64 instructions; nothing
//    here maps to the tensor cores), while an element reads a few numbers
//    and writes one (1 + l with derivatives). So the design cuts the
//    antiderivatives. F is even: (-u)/z is -(u/z), so the square and exp
//    agree; erf is odd; and (c2 (-u)) (-erf) is (c2 u) erf exactly. So the
//    (b, a) entry of a Gram matrix (one batch against itself: every refit
//    step, every rebuild and ingest block) needs exactly the four values of
//    its (a, b) entry, in another inclusion-exclusion order: ((F0 - F2) -
//    F1) + F3 against ((F0 - F1) - F2) + F3. The Gram kernel's grid covers
//    the upper triangle of 32 x 32 tiles only; an off-diagonal block
//    evaluates each pair's antiderivatives once, forms both entries as the
//    general kernel forms them, writes the (a, b) tile directly and the
//    (b, a) tile through a padded shared-memory transpose, so both tiles
//    are written coalesced. A diagonal block computes every entry of its
//    tile as the general kernel does. Every entry is bitwise the general
//    kernel's.
//  * Derivatives share u/z, exp and erf with F: a few multiplies more an
//    antiderivative and l more numbers written an element. They are written
//    only when the lengthscales need a gradient, and the backward no longer
//    evaluates a single exp or erf.
//  * The reduction (se_cov_reduce_launch_*): bytes. It reads G and D once,
//    (1 + l) n_i n_j numbers (128 MB at 2000 x 2000, l = 3, f64); each
//    thread has its 8 elements of G and the 8 l of D in flight at once.
//    Fixed-order block partials (a shuffle tree, then the warps in order),
//    then the ordered fold of se_cov_fold. No float atomics: every run
//    gives the same bits.
//  * Arithmetic in the plain PyTorch version's operation order with
//    explicit round-to-nearest intrinsics (no contraction into FMAs), so
//    that each dimension's integral is the plain version's to the bit; exp
//    and erf are CUDA's math library (the functions PyTorch's own CUDA exp
//    and erf call). Kernels are templated on the type (the reference takes
//    f64 and f32) and on l (0..MAX_L), so the per-dimension values stay in
//    registers.
//  * Any l above MAX_L takes the kernels for any width (se_cov_any,
//    se_cov_reduce_any; redesigned for Hopper), with the same three
//    contracts: the f64 per-dimension integrals are the plain version's
//    bits, D is se_cov_derivs_ref's, a Gram matrix is the general
//    kernel's bits. What bounds them is what bounds the templated ones
//    (the FP64 pipe), so the design keeps theirs: the Gram kernel covers
//    the upper triangle of AT x AT tiles and evaluates each symmetric
//    pair's antiderivatives once (tiles of 8, a pair a thread: a thread
//    keeps its pair's derivative chains, below); the ranges and
//    lengthscale factors of a tile are staged in shared memory, AD dims at
//    a time, dim-major; the dims loop at run time. With derivatives a
//    thread keeps, for AD dims k, R_k (the product of the other dims' g_j,
//    from 1 in ascending j: the plain version's left fold, started from
//    the running product when dim k arrives) and dg_k in shared memory,
//    for both entries of a Gram pair (in registers they took 213 a
//    thread: 8 warps an SM), and writes D_k = (s R_k) dg_k once; past AD
//    dims the antiderivatives are evaluated again for each further AD
//    dims' chains. Nothing goes through device memory but the inputs and
//    the outputs. The general forward without derivatives
//    (se_cov_general_any) reads its ranges where they lie: staged, it was
//    slower. The reduction reads each element of G once for a group of up
//    to RED_GROUP dimensions.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int TI = 8;     // general forward: rows (i side) per block
constexpr int TJ = 32;    // general forward: columns (j side) per block
constexpr int GT = 32;    // Gram forward: side of a square tile
constexpr int GR = 8;     // Gram forward: thread rows (GT / GR rows each)
constexpr int MAX_L = 8;  // numeric dimensions the templated kernels take
constexpr int AT = 8;     // any l, Gram forward: side of a tile (a pair a thread)
constexpr int AD = 12;    // any l: dims staged at once, derivative chains a pass
constexpr int RED_GROUP = 8;  // any l, reduction: dimensions a block
constexpr int RED_THREADS = 256;
constexpr int RED_EACH = 8;                        // elements a thread
constexpr int RED_CHUNK = RED_THREADS * RED_EACH;  // elements a block
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

// F(u; z) and, when grad is set, dF/dz, sharing u/z, exp and erf. c1 and c2
// are (-0.5 z) z and (0.5 sqrt(pi)) z.
template <typename T, bool grad>
__device__ __forceinline__ void antideriv(T u, T z, T c1, T c2, T* f, T* df) {
  const T r = rdiv(u, z);
  const T e = rexp(-rmul(r, r));
  const T er = rerf(r);
  *f = rsub(rmul(c1, e), rmul(rmul(c2, u), er));
  if (grad) *df = rsub(rmul(-z, e), rmul(rmul(T(HALF_SQRT_PI), u), er));
}

// The four antiderivatives of one dimension (antideriv's arithmetic on
// each), phase by phase: the four quotients, then the four exps, then the
// four erfs, so that independent chains sit side by side for the
// scheduler (each erf's branches would otherwise hold the next).
template <typename T, bool grad>
__device__ __forceinline__ void antideriv4(const T (&u)[4], T z, T c1, T c2,
                                           T (&f)[4], T (&df)[4]) {
  T r[4], e[4], er[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = rdiv(u[i], z);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = rexp(-rmul(r[i], r[i]));
#pragma unroll
  for (int i = 0; i < 4; ++i) er[i] = rerf(r[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = rsub(rmul(c1, e[i]), rmul(rmul(c2, u[i]), er[i]));
    if (grad)
      df[i] = rsub(rmul(-z, e[i]), rmul(rmul(T(HALF_SQRT_PI), u[i]), er[i]));
  }
}

// Inclusion-exclusion over the four antiderivatives of one dimension of the
// pair (a, b), taken at b-d, b-c, a-d, a-c ([a, b] the i side's range,
// [c, d] the j side's): the (a, b) entry in the plain version's order,
// ((f0 - f1) - f2) + f3, or, `swapped`, the (b, a) entry, whose second and
// third antiderivatives are (a, b)'s third and second.
template <typename T>
__device__ __forceinline__ T incl_excl(const T* f, bool swapped) {
  return radd(rsub(rsub(f[0], f[swapped ? 2 : 1]), f[swapped ? 1 : 2]), f[3]);
}

// A block's staged inputs: ranges (rows, L) and norms of its i-side and
// j-side rows, and the lengthscales with their two factors.
template <typename T, int L, int RI, int RJ>
struct Staged {
  static constexpr int LS = L > 0 ? L : 1;
  T a[RI * LS], b[RI * LS], ni[RI];
  T c[RJ * LS], d[RJ * LS], nj[RJ];
  T z[LS], c1[LS], c2[LS];
};

// Rows past n get the unit range [0, 1] and norm 1, and are never written.
template <typename T, int L>
__device__ __forceinline__ void stage_side(const T* lo, const T* hi,
                                           const T* norm, int row0, int rows,
                                           int n, T* lo_s, T* hi_s, T* norm_s,
                                           int tid, int threads) {
  constexpr int LS = L > 0 ? L : 1;
  for (int e = tid; e < rows * L; e += threads) {
    const bool in = row0 + e / LS < n;
    lo_s[e] = in ? lo[(size_t)row0 * L + e] : T(0);
    hi_s[e] = in ? hi[(size_t)row0 * L + e] : T(1);
  }
  for (int e = tid; e < rows; e += threads)
    norm_s[e] = row0 + e < n ? norm[row0 + e] : T(1);
}

template <typename T, int L, int RI, int RJ>
__device__ __forceinline__ void stage(Staged<T, L, RI, RJ>& s, const T* lo_i,
                                      const T* hi_i, const T* norm_i, int i0,
                                      int ni, const T* lo_j, const T* hi_j,
                                      const T* norm_j, int j0, int nj,
                                      const T* ls, int tid, int threads) {
  stage_side<T, L>(lo_i, hi_i, norm_i, i0, RI, ni, s.a, s.b, s.ni, tid,
                   threads);
  stage_side<T, L>(lo_j, hi_j, norm_j, j0, RJ, nj, s.c, s.d, s.nj, tid,
                   threads);
  if (tid < L) {
    const T z = ls[tid];
    s.z[tid] = z;
    s.c1[tid] = rmul(rmul(T(-0.5), z), z);
    s.c2[tid] = rmul(T(HALF_SQRT_PI), z);
  }
  __syncthreads();
}

// The per-dimension integrals (and with derivs their z-derivatives) of the
// pair (i-side row ra, j-side row rb): the (a, b) entry's into ii/dii and,
// with `both`, the (b, a) entry's into jj/djj from the same antiderivatives.
template <typename T, int L, bool derivs, bool both, int RI, int RJ>
__device__ __forceinline__ void integrals(const Staged<T, L, RI, RJ>& s,
                                          int ra, int rb, T* ii, T* dii,
                                          T* jj, T* djj) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const T a = s.a[ra * L + k], b = s.b[ra * L + k];
    const T c = s.c[rb * L + k], d = s.d[rb * L + k];
    const T z = s.z[k], c1 = s.c1[k], c2 = s.c2[k];
    T f[4], df[4] = {T(0), T(0), T(0), T(0)};
    antideriv<T, derivs>(rsub(b, d), z, c1, c2, &f[0], &df[0]);
    antideriv<T, derivs>(rsub(b, c), z, c1, c2, &f[1], &df[1]);
    antideriv<T, derivs>(rsub(a, d), z, c1, c2, &f[2], &df[2]);
    antideriv<T, derivs>(rsub(a, c), z, c1, c2, &f[3], &df[3]);
    ii[k] = incl_excl(f, false);
    if (derivs) dii[k] = incl_excl(df, false);
    if (both) {
      jj[k] = incl_excl(f, true);
      if (derivs) djj[k] = incl_excl(df, true);
    }
  }
}

// One entry from its per-dimension integrals: the clamp, the product ((g0
// g1) g2 ...) and the scale as the plain version does them (nn = norm_i
// norm_j); with derivs also D_k = (s prod_{j!=k} g_j) dg_k into dv.
template <typename T, int L, bool derivs>
__device__ __forceinline__ T entry(const T* ii, const T* dii, T sigma2, T nn,
                                   T* dv) {
  T g[L > 0 ? L : 1];
  T acc = T(1);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    g[k] = ii[k] < T(0) ? T(0) : ii[k];  // clamp(min=0): NaN stays NaN
    acc = rmul(acc, g[k]);
  }
  if constexpr (derivs) {
    const T s = rdiv(sigma2, nn);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      T others = T(1);
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (j != k) others = rmul(others, g[j]);
      dv[k] = rmul(rmul(s, others), ii[k] >= T(0) ? dii[k] : T(0));
    }
  }
  return rdiv(rmul(sigma2, acc), nn);
}

// General forward: one thread per (a, b), a block of TI x TJ.
template <typename T, int L, bool derivs>
__global__ void __launch_bounds__(TI * TJ)
se_cov_fwd(const T* __restrict__ lo_i, const T* __restrict__ hi_i,
           const T* __restrict__ lo_j, const T* __restrict__ hi_j,
           const T* __restrict__ ls, const T* __restrict__ norm_i,
           const T* __restrict__ norm_j, T sigma2, int ni, int nj,
           T* __restrict__ out, T* __restrict__ dout) {
  constexpr int LS = L > 0 ? L : 1;
  __shared__ Staged<T, L, TI, TJ> s;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  stage(s, lo_i, hi_i, norm_i, i0, ni, lo_j, hi_j, norm_j, j0, nj, ls,
        threadIdx.y * TJ + threadIdx.x, TI * TJ);
  const int a = i0 + threadIdx.y, b = j0 + threadIdx.x;
  if (a >= ni || b >= nj) return;
  T ii[LS], dii[LS], dv[LS];
  integrals<T, L, derivs, false>(s, threadIdx.y, threadIdx.x, ii, dii,
                                 nullptr, nullptr);
  const size_t at = (size_t)a * nj + b;
  out[at] = entry<T, L, derivs>(ii, dii, sigma2,
                                rmul(s.ni[threadIdx.y], s.nj[threadIdx.x]),
                                dv);
  if constexpr (derivs) {
    const size_t plane = (size_t)ni * nj;
#pragma unroll
    for (int k = 0; k < L; ++k) dout[k * plane + at] = dv[k];
  }
}

// Block `block` of the Gram grid covers tile (ti, tj), ti <= tj: the upper
// triangle of an n_tiles x n_tiles grid of tiles, row by row. Row i starts
// at block i t - i (i - 1) / 2 (t = n_tiles): the root of that quadratic,
// corrected to the exact row.
__host__ __device__ inline long long gram_row_start(long long t,
                                                    long long i) {
  return i * t - i * (i - 1) / 2;
}
__host__ __device__ inline void gram_tile(int n_tiles, int block, int* ti,
                                          int* tj) {
  const long long t = n_tiles;
  const double w = 2.0 * t + 1.0;
  long long i = static_cast<long long>(0.5 * (w - sqrt(w * w - 8.0 * block)));
  i = i < 0 ? 0 : (i > t - 1 ? t - 1 : i);
  while (i > 0 && gram_row_start(t, i) > block) --i;
  while (i + 1 < t && gram_row_start(t, i + 1) <= block) ++i;
  *ti = static_cast<int>(i);
  *tj = static_cast<int>(i + (block - gram_row_start(t, i)));
}

// Gram forward: out = K(x, x). A block of GT x GR threads owns tile (ti,
// tj); thread (x, y) computes the pairs (ti GT + y + GR r, tj GT + x) for
// r < GT / GR. Dynamic shared memory: (derivs ? L + 1 : 1) planes of
// GT x (GT + 1), the transposed tile of out (and of each D_k).
template <typename T, int L, bool derivs>
__global__ void __launch_bounds__(GT * GR)
se_cov_gram(const T* __restrict__ lo, const T* __restrict__ hi,
            const T* __restrict__ ls, const T* __restrict__ norm, T sigma2,
            int n, T* __restrict__ out, T* __restrict__ dout) {
  constexpr int LS = L > 0 ? L : 1;
  __shared__ Staged<T, L, GT, GT> s;
  extern __shared__ __align__(16) unsigned char tr_raw[];
  T(*tr)[GT + 1] = reinterpret_cast<T(*)[GT + 1]>(tr_raw);
  int ti, tj;
  gram_tile((n + GT - 1) / GT, blockIdx.x, &ti, &tj);
  const int i0 = ti * GT, j0 = tj * GT;
  stage(s, lo, hi, norm, i0, n, lo, hi, norm, j0, n, ls,
        threadIdx.y * GT + threadIdx.x, GT * GR);
  const bool diag = ti == tj;
  const size_t plane = (size_t)n * n;
#pragma unroll 1
  for (int r = 0; r < GT / GR; ++r) {
    const int al = threadIdx.y + GR * r, bl = threadIdx.x;
    const int a = i0 + al, b = j0 + bl;
    T ii[LS], dii[LS], jj[LS], djj[LS], dv[LS];
    integrals<T, L, derivs, true>(s, al, bl, ii, dii, jj, djj);
    // norm_a norm_b: the (b, a) entry's norm_b norm_a has the same bits.
    const T nn = rmul(s.ni[al], s.nj[bl]);
    const T v = entry<T, L, derivs>(ii, dii, sigma2, nn, dv);
    if (a < n && b < n) {
      const size_t at = (size_t)a * n + b;
      out[at] = v;
      if constexpr (derivs) {
#pragma unroll
        for (int k = 0; k < L; ++k) dout[k * plane + at] = dv[k];
      }
    }
    if (!diag) {
      const T w = entry<T, L, derivs>(jj, djj, sigma2, nn, dv);
      tr[bl][al] = w;
      if constexpr (derivs) {
#pragma unroll
        for (int k = 0; k < L; ++k) tr[(k + 1) * GT + bl][al] = dv[k];
      }
    }
  }
  if (diag) return;  // uniform over the block
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < GT / GR; ++r) {
    const int bl = threadIdx.y + GR * r, al = threadIdx.x;
    const int a = i0 + al, b = j0 + bl;
    if (a < n && b < n) {
      const size_t at = (size_t)b * n + a;
      out[at] = tr[bl][al];
      if constexpr (derivs) {
#pragma unroll
        for (int k = 0; k < L; ++k) dout[k * plane + at] = tr[(k + 1) * GT + bl][al];
      }
    }
  }
}

// part[block, k] = sum over the block's RED_CHUNK elements e of G[e] D_k[e]
// (D is (L, m)): thread t sums e = t, t + 256, ... in order, then a fixed
// shuffle tree within each warp and the warps in order.
template <typename T, int L>
__global__ void __launch_bounds__(RED_THREADS)
se_cov_reduce(const T* __restrict__ G, const T* __restrict__ D, long long m,
              T* __restrict__ part) {
  constexpr int LS = L > 0 ? L : 1;
  __shared__ T warp_s[RED_THREADS / 32][LS];
  const long long base = (long long)blockIdx.x * RED_CHUNK + threadIdx.x;
  T g[RED_EACH], acc[LS];
#pragma unroll
  for (int i = 0; i < RED_EACH; ++i) {
    const long long e = base + (long long)i * RED_THREADS;
    g[i] = e < m ? G[e] : T(0);
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    acc[k] = T(0);
#pragma unroll
    for (int i = 0; i < RED_EACH; ++i) {
      const long long e = base + (long long)i * RED_THREADS;
      if (e < m) acc[k] += g[i] * D[k * m + e];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    T v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_s[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < L) {
    T t = T(0);
    for (int w = 0; w < RED_THREADS / 32; ++w) t += warp_s[w][threadIdx.x];
    part[(size_t)blockIdx.x * L + threadIdx.x] = t;
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

// The general forward for any l without derivatives: one thread per
// (a, b), a block of TI x TJ, the ranges and lengthscales read where they
// lie. Staging them as se_cov_any does cost more in barriers than it saved
// at improve's 128 x 2000 (3-6% slower), so this route keeps this plain
// body; se_cov_any's general form (no Gram) runs with derivatives only.
template <typename T>
__global__ void __launch_bounds__(TI * TJ)
se_cov_general_any(const T* __restrict__ lo_i, const T* __restrict__ hi_i,
                   const T* __restrict__ lo_j, const T* __restrict__ hi_j,
                   const T* __restrict__ ls, const T* __restrict__ norm_i,
                   const T* __restrict__ norm_j, T sigma2, int ni, int nj,
                   int l, T* __restrict__ out) {
  const int a = blockIdx.y * TI + threadIdx.y;
  const int b = blockIdx.x * TJ + threadIdx.x;
  if (a >= ni || b >= nj) return;
  T acc = T(1);
  for (int k = 0; k < l; ++k) {
    const T z = ls[k];
    const T c1 = rmul(rmul(T(-0.5), z), z), c2 = rmul(T(HALF_SQRT_PI), z);
    const T ra = lo_i[(size_t)a * l + k], rb = hi_i[(size_t)a * l + k];
    const T rc = lo_j[(size_t)b * l + k], rd = hi_j[(size_t)b * l + k];
    T f[4];
    antideriv<T, false>(rsub(rb, rd), z, c1, c2, &f[0], nullptr);
    antideriv<T, false>(rsub(rb, rc), z, c1, c2, &f[1], nullptr);
    antideriv<T, false>(rsub(ra, rd), z, c1, c2, &f[2], nullptr);
    antideriv<T, false>(rsub(ra, rc), z, c1, c2, &f[3], nullptr);
    const T ii = incl_excl(f, false);
    acc = rmul(acc, ii < T(0) ? T(0) : ii);  // clamp(min=0): NaN stays NaN
  }
  const T nn = rmul(norm_i[a], norm_j[b]);
  out[(size_t)a * nj + b] = rdiv(rmul(sigma2, acc), nn);
}

// The forwards for any l (above MAX_L): the general one with derivatives
// (gram false: a block of RI x TJ entries, one a thread) and the Gram one
// (gram true: the
// upper triangle of AT x AT tiles, one pair a thread; an off-diagonal block
// also forms the (b, a) entry from the pair's antiderivatives and writes it
// through shared memory transposed, as se_cov_gram does). The dimensions
// run at run time, AD at a time: the block stages the ranges and
// lengthscale factors of AD dims of its rows, dim-major (a warp reads
// consecutive rows: no bank conflict), then every thread folds those dims,
// a dim's four antiderivatives phase by phase (antideriv4: more work in
// flight a thread).
// With derivatives a thread keeps, for the AD dims k of a pass, R_k (the
// product of the other dims' g_j from 1 in ascending j, k skipped: the
// plain version's left fold) and dg_k in shared memory, [k][thread], for
// both entries of a Gram pair: R_k starts as the running product over
// dims 0..k-1 when dim k arrives and takes every later g_j, so a dim
// multiplies only the chains already started. Past AD dims the
// antiderivatives are evaluated again for each further AD dims' chains.
// D_k = (s R_k) dg_k is written once: no scratch in device memory.
template <typename T, bool derivs, bool gram>
__global__ void __launch_bounds__(gram ? AT * AT : (derivs ? TI / 2 : TI) * TJ)
se_cov_any(const T* __restrict__ lo_i, const T* __restrict__ hi_i,
           const T* __restrict__ lo_j, const T* __restrict__ hi_j,
           const T* __restrict__ ls, const T* __restrict__ norm_i,
           const T* __restrict__ norm_j, T sigma2, int ni, int nj, int l,
           T* __restrict__ out, T* __restrict__ dout) {
  constexpr int RI = gram ? AT : (derivs ? TI / 2 : TI);
  constexpr int RJ = gram ? AT : TJ, NT = RI * RJ;
  constexpr int KD = derivs ? AD : 1;  // chains a pass
  constexpr int KM = derivs && gram ? AD : 1;  // mirror chains
  __shared__ T sa[AD][RI], sb[AD][RI], sc[AD][RJ], sd[AD][RJ];
  __shared__ T sz[AD], sc1[AD], sc2[AD], sni[RI], snj[RJ];
  __shared__ T rs[KD][NT], dgs[KD][NT], rms[KM][NT], dgms[KM][NT];
  __shared__ T mo[gram ? NT : 1];  // the (b, a) entries of out
  const int tid = threadIdx.x, x = tid % RJ, y = tid / RJ;
  int i0, j0;
  bool mirror = false;
  if constexpr (gram) {
    int ti, tj;
    gram_tile((ni + AT - 1) / AT, blockIdx.x, &ti, &tj);
    i0 = ti * AT;
    j0 = tj * AT;
    mirror = ti != tj;  // uniform over the block
  } else {
    i0 = blockIdx.y * RI;
    j0 = blockIdx.x * RJ;
  }
  const int a = i0 + y, b = j0 + x;
  const bool in = a < ni && b < nj;
  // Rows past n: the unit range [0, 1] and norm 1, never written.
  if (tid < RI) sni[tid] = i0 + tid < ni ? norm_i[i0 + tid] : T(1);
  if (tid < RJ) snj[tid] = j0 + tid < nj ? norm_j[j0 + tid] : T(1);
  const size_t plane = (size_t)ni * nj;
  const int passes = derivs ? (l + AD - 1) / AD : 1;
  for (int p = 0; p < passes; ++p) {
    const int k0 = p * AD;
    T P = T(1), Pm = T(1);  // the product over the dims so far, (a, b), (b, a)
    for (int s0 = 0; s0 < l; s0 += AD) {
      const int ns = min(AD, l - s0);
      __syncthreads();  // the last slice (and the last pass) is read
      for (int e = tid; e < ns * RI; e += NT) {
        const int k = e / RI, r = e % RI, row = i0 + r;
        const bool ok = row < ni;
        sa[k][r] = ok ? lo_i[(size_t)row * l + s0 + k] : T(0);
        sb[k][r] = ok ? hi_i[(size_t)row * l + s0 + k] : T(1);
      }
      for (int e = tid; e < ns * RJ; e += NT) {
        const int k = e / RJ, r = e % RJ, row = j0 + r;
        const bool ok = row < nj;
        sc[k][r] = ok ? lo_j[(size_t)row * l + s0 + k] : T(0);
        sd[k][r] = ok ? hi_j[(size_t)row * l + s0 + k] : T(1);
      }
      if (tid < ns) {
        const T z = ls[s0 + tid];
        sz[tid] = z;
        sc1[tid] = rmul(rmul(T(-0.5), z), z);
        sc2[tid] = rmul(T(HALF_SQRT_PI), z);
      }
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < ns; ++k) {
        const int j = s0 + k, cj = j - k0;  // dim j's chain of this pass
        const T ra = sa[k][y], rb = sb[k][y], rc = sc[k][x], rd = sd[k][x];
        const T z = sz[k], c1 = sc1[k], c2 = sc2[k];
        const T u[4] = {rsub(rb, rd), rsub(rb, rc), rsub(ra, rd),
                        rsub(ra, rc)};
        T f[4], df[4] = {T(0), T(0), T(0), T(0)};
        antideriv4<T, derivs>(u, z, c1, c2, f, df);
        const T ii = incl_excl(f, false), jj = incl_excl(f, true);
        const T g = ii < T(0) ? T(0) : ii;  // clamp(min=0): NaN stays NaN
        const T gm = jj < T(0) ? T(0) : jj;  // the (b, a) entry's
        const bool both = gram && mirror;
        if constexpr (derivs) {
          // The chains started (c < cj: uniform), loaded ahead of the test
          // so that their loads overlap.
#pragma unroll
          for (int c = 0; c < KD; ++c) {
            const T r = rs[c][tid], rm = rms[c % KM][tid];
            if (c < cj) {
              rs[c][tid] = rmul(r, g);
              if (both) rms[c % KM][tid] = rmul(rm, gm);
            }
          }
          if (cj >= 0 && cj < KD) {
            rs[cj][tid] = P;
            dgs[cj][tid] = ii >= T(0) ? incl_excl(df, false) : T(0);
            if (both) {
              rms[cj % KM][tid] = Pm;
              dgms[cj % KM][tid] = jj >= T(0) ? incl_excl(df, true) : T(0);
            }
          }
        }
        P = rmul(P, g);
        if (both) Pm = rmul(Pm, gm);
      }
    }
    // norm_a norm_b: the (b, a) entry's norm_b norm_a has the same bits.
    const T nn = rmul(sni[y], snj[x]);
    const size_t at = (size_t)a * nj + b;
    const int nk = min(KD, l - k0);
    if constexpr (derivs) {
      const T s = rdiv(sigma2, nn);
      for (int c = 0; c < nk; ++c) {
        if (in) dout[(k0 + c) * plane + at] = rmul(rmul(s, rs[c][tid]),
                                                   dgs[c][tid]);
        if (gram && mirror)  // in place: the (b, a) D_k
          dgms[c][tid] = rmul(rmul(s, rms[c][tid]), dgms[c][tid]);
      }
    }
    if (p == 0) {
      if (in) out[at] = rdiv(rmul(sigma2, P), nn);
      if (gram && mirror) mo[tid] = rdiv(rmul(sigma2, Pm), nn);
    }
    if (gram && mirror) {
      __syncthreads();
      // Thread (x, y) writes row j0 + y, column i0 + x: the (b, a) entry
      // of the pair thread (y, x) formed.
      const int row = j0 + y, col = i0 + x, src = x * RJ + y;
      if (row < nj && col < ni) {
        const size_t mt = (size_t)row * nj + col;
        if (p == 0) out[mt] = mo[src];
        if constexpr (derivs)
          for (int c = 0; c < nk; ++c)
            dout[(k0 + c) * plane + mt] = dgms[c][src];
      }
    }
  }
}

// part[block, k] for the dimensions k of group blockIdx.y (at most
// RED_GROUP, any l): se_cov_reduce's arithmetic, each G element read once
// for its group's dimensions (the same sums in the same order for each
// dimension, whatever the group).
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
se_cov_reduce_any(const T* __restrict__ G, const T* __restrict__ D,
                  long long m, int l, T* __restrict__ part) {
  __shared__ T warp_s[RED_THREADS / 32][RED_GROUP];
  const int k0 = blockIdx.y * RED_GROUP, nk = min(RED_GROUP, l - k0);
  const long long base = (long long)blockIdx.x * RED_CHUNK + threadIdx.x;
  T g[RED_EACH], acc[RED_GROUP];
#pragma unroll
  for (int i = 0; i < RED_EACH; ++i) {
    const long long e = base + (long long)i * RED_THREADS;
    g[i] = e < m ? G[e] : T(0);
  }
#pragma unroll
  for (int k = 0; k < RED_GROUP; ++k) {
    acc[k] = T(0);
    if (k < nk) {
#pragma unroll
      for (int i = 0; i < RED_EACH; ++i) {
        const long long e = base + (long long)i * RED_THREADS;
        if (e < m) acc[k] += g[i] * D[(k0 + k) * m + e];
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < RED_GROUP; ++k) {
    T v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_s[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < nk) {
    T t = T(0);
    for (int w = 0; w < RED_THREADS / 32; ++w) t += warp_s[w][threadIdx.x];
    part[(size_t)blockIdx.x * l + k0 + threadIdx.x] = t;
  }
}

// One antiderivative (and with grad its z-derivative) an element: the
// kernels' own code, for the card's check that F is even bit for bit and
// for counting its FP64 instructions in the built library.
template <typename T, bool grad>
__global__ void se_cov_probe(const T* __restrict__ u, T z, int m,
                             T* __restrict__ f, T* __restrict__ df) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T fv, dfv = T(0);
  antideriv<T, grad>(u[i], z, rmul(rmul(T(-0.5), z), z),
                     rmul(T(HALF_SQRT_PI), z), &fv, &dfv);
  f[i] = fv;
  if (grad) df[i] = dfv;
}

// Run CALL with the constant L equal to the run-time l (0..MAX_L).
#define SE_WITH_L(l, CALL)                   \
  switch (l) {                               \
    case 0: { constexpr int L = 0; return CALL; } \
    case 1: { constexpr int L = 1; return CALL; } \
    case 2: { constexpr int L = 2; return CALL; } \
    case 3: { constexpr int L = 3; return CALL; } \
    case 4: { constexpr int L = 4; return CALL; } \
    case 5: { constexpr int L = 5; return CALL; } \
    case 6: { constexpr int L = 6; return CALL; } \
    case 7: { constexpr int L = 7; return CALL; } \
    case 8: { constexpr int L = 8; return CALL; } \
    default: break;                          \
  }
static_assert(MAX_L == 8, "SE_WITH_L lists l = 0..8");

template <typename T>
struct Args {
  const T *lo_i, *hi_i, *lo_j, *hi_j, *ls, *norm_i, *norm_j;
  T sigma2;
  int ni, nj;
  T *out, *dout;
};

template <typename T, int L, bool derivs>
int fwd_l(const Args<T>& p, cudaStream_t s) {
  const dim3 grid((p.nj + TJ - 1) / TJ, (p.ni + TI - 1) / TI);
  se_cov_fwd<T, L, derivs><<<grid, dim3(TJ, TI), 0, s>>>(
      p.lo_i, p.hi_i, p.lo_j, p.hi_j, p.ls, p.norm_i, p.norm_j, p.sigma2,
      p.ni, p.nj, p.out, p.dout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L, bool derivs>
int gram_l(const Args<T>& p, cudaStream_t s) {
  // The transposed planes; above 48 KB (derivatives at l >= 5 in f64) only
  // after the opt-in.
  constexpr int smem = (derivs ? L + 1 : 1) * GT * (GT + 1) * sizeof(T);
  static uint64_t opted_in = 0;  // devices this instance may use smem on
  cudaError_t e = opt_in_smem(
      reinterpret_cast<const void*>(se_cov_gram<T, L, derivs>), opted_in,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.ni + GT - 1) / GT;
  se_cov_gram<T, L, derivs><<<tiles * (tiles + 1) / 2, dim3(GT, GR), smem,
                              s>>>(p.lo_i, p.hi_i, p.ls, p.norm_i, p.sigma2,
                                   p.ni, p.out, p.dout);
  return static_cast<int>(cudaGetLastError());
}

// Any l above MAX_L: the general or the Gram forward for any width.
template <typename T, bool derivs, bool gram>
int any_l(const Args<T>& p, int l, cudaStream_t s) {
  constexpr int RI = derivs ? TI / 2 : TI;  // general rows: shared chains
  dim3 grid((p.nj + TJ - 1) / TJ, (p.ni + RI - 1) / RI);
  if (gram) {
    const long long t = (p.ni + AT - 1) / AT;
    grid = dim3(static_cast<unsigned>(t * (t + 1) / 2));
  }
  se_cov_any<T, derivs, gram><<<grid, dim3(gram ? AT * AT : RI * TJ), 0, s>>>(
      p.lo_i, p.hi_i, p.lo_j, p.hi_j, p.ls, p.norm_i, p.norm_j, p.sigma2,
      p.ni, p.nj, l, p.out, p.dout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(bool gram, const Args<T>& p, int l, void* stream) {
  if (l < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.ni <= 0 || p.nj <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l > MAX_L) {
    if (gram && p.dout) return any_l<T, true, true>(p, l, s);
    if (gram) return any_l<T, false, true>(p, l, s);
    if (p.dout) return any_l<T, true, false>(p, l, s);
    se_cov_general_any<T><<<dim3((p.nj + TJ - 1) / TJ, (p.ni + TI - 1) / TI),
                            dim3(TJ, TI), 0, s>>>(
        p.lo_i, p.hi_i, p.lo_j, p.hi_j, p.ls, p.norm_i, p.norm_j, p.sigma2,
        p.ni, p.nj, l, p.out);
    return static_cast<int>(cudaGetLastError());
  }
  if (gram && p.dout) SE_WITH_L(l, (gram_l<T, L, true>(p, s)))
  if (gram) SE_WITH_L(l, (gram_l<T, L, false>(p, s)))
  if (p.dout) SE_WITH_L(l, (fwd_l<T, L, true>(p, s)))
  SE_WITH_L(l, (fwd_l<T, L, false>(p, s)))
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int L>
int reduce_l(const T* G, const T* D, long long m, T* part, T* grad_ls,
             cudaStream_t s) {
  const long long blocks = (m + RED_CHUNK - 1) / RED_CHUNK;
  se_cov_reduce<T, L><<<static_cast<unsigned>(blocks), RED_THREADS, 0, s>>>(
      G, D, m, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  se_cov_fold<T><<<L, FOLD_THREADS, 0, s>>>(part, static_cast<int>(blocks),
                                            L, grad_ls);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int reduce_any(const T* G, const T* D, long long m, int l, T* part,
               T* grad_ls, cudaStream_t s) {
  const long long blocks = (m + RED_CHUNK - 1) / RED_CHUNK;
  const int groups = (l + RED_GROUP - 1) / RED_GROUP;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  se_cov_reduce_any<T><<<dim3(static_cast<unsigned>(blocks), groups),
                         RED_THREADS, 0, s>>>(G, D, m, l, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  se_cov_fold<T><<<l, FOLD_THREADS, 0, s>>>(part, static_cast<int>(blocks),
                                            l, grad_ls);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int reduce(const T* G, const T* D, long long m, int l, T* part, T* grad_ls,
           void* stream) {
  if (l < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || l == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l > MAX_L) return reduce_any(G, D, m, l, part, grad_ls, s);
  SE_WITH_L(l, (reduce_l<T, L>(G, D, m, part, grad_ls, s)))
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int probe(const T* u, T z, int m, T* f, T* df, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + 255) / 256;
  if (df)
    se_cov_probe<T, true><<<blocks, 256, 0, s>>>(u, z, m, f, df);
  else
    se_cov_probe<T, false><<<blocks, 256, 0, s>>>(u, z, m, f, df);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). sigma2 and z are passed by value
// (as doubles, rounded to float for the f32 kernels, as PyTorch rounds a
// Python scalar). Every pointer is a device pointer to contiguous data of
// one type: lo_i, hi_i (ni, l); lo_j, hi_j (nj, l); ls (l); norm_i (ni);
// norm_j (nj); out (ni, nj); dout (l, ni, nj), or null for no derivatives.
// The Gram entry takes one side: lo, hi (n, l), norm (n), out (n, n), dout
// (l, n, n) or null. The reduction: G (m), D (l, m), part (ceil(m /
// 2048), l) scratch, grad_ls (l). Kernels run on `stream`, nothing is
// allocated here, and the return value is cudaGetLastError().
extern "C" int se_cov_launch_f64(const double* lo_i, const double* hi_i,
                                 const double* lo_j, const double* hi_j,
                                 const double* ls, const double* norm_i,
                                 const double* norm_j, double sigma2,
                                 int ni, int nj, int l, double* out,
                                 double* dout, void* stream) {
  return forward<double>(false, {lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                                 sigma2, ni, nj, out, dout}, l, stream);
}

extern "C" int se_cov_launch_f32(const float* lo_i, const float* hi_i,
                                 const float* lo_j, const float* hi_j,
                                 const float* ls, const float* norm_i,
                                 const float* norm_j, double sigma2,
                                 int ni, int nj, int l, float* out,
                                 float* dout, void* stream) {
  return forward<float>(false, {lo_i, hi_i, lo_j, hi_j, ls, norm_i, norm_j,
                                static_cast<float>(sigma2), ni, nj, out,
                                dout}, l, stream);
}

extern "C" int se_cov_gram_launch_f64(const double* lo, const double* hi,
                                      const double* ls, const double* norm,
                                      double sigma2, int n, int l,
                                      double* out, double* dout,
                                      void* stream) {
  return forward<double>(true, {lo, hi, lo, hi, ls, norm, norm, sigma2, n,
                                n, out, dout}, l, stream);
}

extern "C" int se_cov_gram_launch_f32(const float* lo, const float* hi,
                                      const float* ls, const float* norm,
                                      double sigma2, int n, int l,
                                      float* out, float* dout,
                                      void* stream) {
  return forward<float>(true, {lo, hi, lo, hi, ls, norm, norm,
                               static_cast<float>(sigma2), n, n, out, dout},
                        l, stream);
}

extern "C" int se_cov_reduce_launch_f64(const double* G, const double* D,
                                        long long m, int l, double* part,
                                        double* grad_ls, void* stream) {
  return reduce<double>(G, D, m, l, part, grad_ls, stream);
}

extern "C" int se_cov_reduce_launch_f32(const float* G, const float* D,
                                        long long m, int l, float* part,
                                        float* grad_ls, void* stream) {
  return reduce<float>(G, D, m, l, part, grad_ls, stream);
}

// F (and dF/dz when df is not null) at each of the m values of u.
extern "C" int se_cov_probe_f64(const double* u, double z, int m, double* f,
                                double* df, void* stream) {
  return probe<double>(u, z, m, f, df, stream);
}

extern "C" int se_cov_probe_f32(const float* u, double z, int m, float* f,
                                float* df, void* stream) {
  return probe<float>(u, static_cast<float>(z), m, f, df, stream);
}

// The launch plans, for the wrapper's tests, of a Gram matrix of n
// snippets over l dims: out = {Gram tile side, Gram thread rows a block,
// tiles a side at n, Gram blocks at n, elements a reduction block, the
// widest l with templated kernels}; tiles, when not null, gets (ti, tj)
// of every Gram block. Above that l the Gram kernel for any width takes
// tiles of AT x AT, a pair a thread (AT thread rows). Returns 0.
extern "C" int se_cov_plan(int n, int l, int* out, int* tiles) {
  const int side = l <= MAX_L ? GT : AT;
  const int t = (n + side - 1) / side;
  const int blocks = t * (t + 1) / 2;
  out[0] = side;
  out[1] = l <= MAX_L ? GR : AT;
  out[2] = t;
  out[3] = blocks;
  out[4] = RED_CHUNK;
  out[5] = MAX_L;
  if (tiles)
    for (int b = 0; b < blocks; ++b)
      gram_tile(t, b, &tiles[2 * b], &tiles[2 * b + 1]);
  return 0;
}
