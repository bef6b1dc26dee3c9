// Fused masked scan for Hopper (sm_90a): the scan of every sample batch.
// This file holds K1 (fms_partials, entry point fms_launch) and K4
// (mpa_partials, entry point mpa_launch, further down), which share the
// chunked fixed-order fold and its second pass (fms_fold_chunks).
//
// Replaces the TPU kernel src/repro/kernels/fused_masked_scan/kernel.py
// (_fms_kernel, launched by fused_masked_scan_pallas). For each snippet q
// and payload column p it computes, over the tuples t of one block,
//
//     out[q, p] = sum_t mask[t, q] * payload[t, p]
//     mask[t, q] = valid[t] * AND_k (lo[q,k] - eps <= x[t,k] <= hi[q,k] + eps)
//                           * AND_k member(q, k, codes[t,k])
//     payload[t] = [m_0 .. m_{M-1}, m_0^2 .. m_{M-1}^2, 1]
//
// What bounds it on the H100: per (tuple, snippet) pair it does 2L compares,
// C table lookups and 2M+1 f64 multiply-adds, and it reads each tuple once:
// ~T*(8L + 4C + 8M) bytes (3.1 MB, ~1 us, for a 60,000-tuple batch). The
// f64 operations bound it at every snippet count the engine uses (~4 us at
// Q = 128, ~0.14 ms at Q = 4096); at Q = 128 the launch dominates.
//
// Design:
//  * The mask is computed on the fly and never written to memory. One thread
//    owns one snippet; a block owns SNIPPETS_PER_BLOCK snippets and one fixed
//    chunk of tuples. Tuples are staged through shared memory tile by tile,
//    and every thread of a warp reads the same tuple (a broadcast).
//  * Categorical membership is a lookup in a per-block (C x V x TQ) uint8
//    table in shared memory instead of the TPU's one-hot matmul; the
//    payload [m, m^2, 1] is built in registers, never materialised.
//  * f64 accumulation (Hopper has FP64) with no float atomics: block
//    (chunk c, snippet tile) folds its chunk's tuples in ascending order into
//    scratch[c, q, :]; a second pass sums the chunks in ascending order. The
//    sum order depends only on T, so every run gives the same bits, and a
//    snippet's sums do not depend on how many snippets ride along. A small
//    chunk (256 tuples) gives the serving shape (one snippet tile) enough
//    blocks to fill the card. The count column sums exact 0/1 values.
//  * m^2 is rounded before it is scaled (__dmul_rn), as the plain version
//    does, so no contraction into an FMA changes its rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SNIPPETS_PER_BLOCK = 128;  // TQ: one thread per snippet
constexpr int TUPLES_PER_TILE = 128;     // tuples staged in shared memory
constexpr int MAX_M = 8;                 // measures kept in registers

__global__ void fms_partials(const double* __restrict__ x,
                             const int* __restrict__ codes,
                             const double* __restrict__ valid,
                             const double* __restrict__ meas,
                             const double* __restrict__ lo,
                             const double* __restrict__ hi,
                             const uint8_t* __restrict__ cat,
                             int T, int Q, int L, int C, int V, int M,
                             int chunk, double eps,
                             double* __restrict__ scratch) {
  constexpr int TQ = SNIPPETS_PER_BLOCK;
  constexpr int TT = TUPLES_PER_TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  double* lo_s = reinterpret_cast<double*>(smem);  // [L][TQ]
  double* hi_s = lo_s + L * TQ;                    // [L][TQ]
  double* x_s = hi_s + L * TQ;                     // [TT][L]
  double* m_s = x_s + TT * L;                      // [TT][M]
  double* v_s = m_s + TT * M;                      // [TT]
  int* code_s = reinterpret_cast<int*>(v_s + TT);  // [TT][C]
  uint8_t* cat_s = reinterpret_cast<uint8_t*>(code_s + TT * C);  // [C*V][TQ]

  const int tid = threadIdx.x;
  const int q = blockIdx.y * TQ + tid;
  const bool live = q < Q;
  const int t_begin = blockIdx.x * chunk;
  const int t_end = min(T, t_begin + chunk);

  for (int k = 0; k < L; ++k) {
    lo_s[k * TQ + tid] = live ? lo[(size_t)q * L + k] - eps : 0.0;
    hi_s[k * TQ + tid] = live ? hi[(size_t)q * L + k] + eps : 0.0;
  }
  for (int j = 0; j < C * V; ++j)
    cat_s[j * TQ + tid] = live ? cat[(size_t)q * C * V + j] : 0;

  double acc_s[MAX_M], acc_q[MAX_M], acc_n = 0.0;
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) acc_s[j] = acc_q[j] = 0.0;

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    __syncthreads();  // the previous tile (and the table) is fully read
    for (int i = tid; i < n * L; i += TQ) x_s[i] = x[(size_t)t0 * L + i];
    for (int i = tid; i < n * M; i += TQ) m_s[i] = meas[(size_t)t0 * M + i];
    for (int i = tid; i < n * C; i += TQ) code_s[i] = codes[(size_t)t0 * C + i];
    for (int i = tid; i < n; i += TQ) v_s[i] = valid ? valid[t0 + i] : 1.0;
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < n; ++t) {
      bool hit = true;
      for (int k = 0; k < L; ++k) {
        const double xv = x_s[t * L + k];
        hit = hit && (xv >= lo_s[k * TQ + tid]) && (xv <= hi_s[k * TQ + tid]);
      }
      for (int k = 0; k < C; ++k) {
        const int code = code_s[t * C + k];
        hit = hit && (unsigned)code < (unsigned)V &&
              cat_s[(k * V + code) * TQ + tid] != 0;
      }
      const double w = hit ? v_s[t] : 0.0;
#pragma unroll
      for (int j = 0; j < MAX_M; ++j) {
        if (j < M) {
          const double mv = m_s[t * M + j];
          acc_s[j] = __fma_rn(w, mv, acc_s[j]);
          acc_q[j] = __fma_rn(w, __dmul_rn(mv, mv), acc_q[j]);
        }
      }
      acc_n += w;
    }
  }
  if (!live) return;
  const int P = 2 * M + 1;
  double* dst = scratch + ((size_t)blockIdx.x * Q + q) * P;
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) {
    if (j < M) {
      dst[j] = acc_s[j];
      dst[M + j] = acc_q[j];
    }
  }
  dst[2 * M] = acc_n;
}

// K4, masked partials: the same fold over a mask built outside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/fused_masked_scan/kernel.py
// (_mpa_kernel, launched by masked_partials_pallas): the sharded placement
// builds the (T, Q) 0/1 mask shard by shard, gathers it onto one device and
// folds it here against [m, m^2, 1]:
//
//     out[q, p] = sum_t mask[t, q] * payload[t, p]
//
// What bounds it on the H100: bytes. It reads the f64 mask once, T*Q*8
// bytes (61.4 MB, ~18 us at 3.35 TB/s for T = 60,000 and Q = 128), and does
// ~2(2M+1) operations per mask entry (~1 us of f64 work).
//
// Design: K1's, with the mask read instead of computed. One thread owns one
// snippet, so the threads of a warp read neighbouring q of one mask row
// (coalesced). Block (chunk c, snippet tile) folds its chunk's tuples in
// ascending order, with K1's own per-tuple update on the mask value w, into
// scratch[c, q, :]; fms_fold_chunks sums the chunks in ascending order. On a
// 0/1 mask built from the same predicates the result is therefore bitwise
// K1's on the same block, which is what makes a mesh session answer bitwise
// like a local one. No float atomics.
__global__ void mpa_partials(const double* __restrict__ mask,
                             const double* __restrict__ meas, int T, int Q,
                             int M, int chunk, double* __restrict__ scratch) {
  constexpr int TQ = SNIPPETS_PER_BLOCK;
  constexpr int TT = TUPLES_PER_TILE;
  __shared__ double m_s[TT * MAX_M];  // [TT][M]

  const int tid = threadIdx.x;
  const int q = blockIdx.y * TQ + tid;
  const bool live = q < Q;
  const int t_begin = blockIdx.x * chunk;
  const int t_end = min(T, t_begin + chunk);

  double acc_s[MAX_M], acc_q[MAX_M], acc_n = 0.0;
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) acc_s[j] = acc_q[j] = 0.0;

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    __syncthreads();  // the previous tile is fully read
    for (int i = tid; i < n * M; i += TQ) m_s[i] = meas[(size_t)t0 * M + i];
    __syncthreads();
    if (!live) continue;
    const double* col = mask + (size_t)t0 * Q + q;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const double w = col[(size_t)t * Q];
#pragma unroll
      for (int j = 0; j < MAX_M; ++j) {
        if (j < M) {
          const double mv = m_s[t * M + j];
          acc_s[j] = __fma_rn(w, mv, acc_s[j]);
          acc_q[j] = __fma_rn(w, __dmul_rn(mv, mv), acc_q[j]);
        }
      }
      acc_n += w;
    }
  }
  if (!live) return;
  const int P = 2 * M + 1;
  double* dst = scratch + ((size_t)blockIdx.x * Q + q) * P;
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) {
    if (j < M) {
      dst[j] = acc_s[j];
      dst[M + j] = acc_q[j];
    }
  }
  dst[2 * M] = acc_n;
}

// out[i] = sum over chunks c = 0, 1, ... of scratch[c, i], in that order.
__global__ void fms_fold_chunks(const double* __restrict__ scratch,
                                int n_chunks, int n, double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += scratch[(size_t)c * n + i];
  out[i] = s;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches both passes on `stream`,
// allocates nothing, and returns cudaGetLastError().
// scratch: (ceil(T/chunk), Q, 2M+1) f64; out: (Q, 2M+1) f64.
// valid may be null (every tuple valid).
extern "C" int fms_launch(const double* x, const int* codes,
                          const double* valid, const double* meas,
                          const double* lo, const double* hi,
                          const uint8_t* cat, int T, int Q, int L, int C,
                          int V, int M, int chunk, double eps,
                          double* scratch, double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (M > MAX_M || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0) {
    constexpr int TQ = SNIPPETS_PER_BLOCK;
    constexpr int TT = TUPLES_PER_TILE;
    const size_t smem = sizeof(double) * (2 * L * TQ + TT * L + TT * M + TT) +
                        sizeof(int) * TT * C + (size_t)C * V * TQ;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fms_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid(n_chunks, (Q + TQ - 1) / TQ);
    fms_partials<<<grid, TQ, smem, s>>>(x, codes, valid, meas, lo, hi, cat, T,
                                         Q, L, C, V, M, chunk, eps, scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = Q * (2 * M + 1);
  fms_fold_chunks<<<(n + 255) / 256, 256, 0, s>>>(scratch, n_chunks, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of K4 (bound with ctypes). Launches both passes on
// `stream`, allocates nothing, and returns cudaGetLastError().
// mask: (T, Q) f64; meas: (T, M) f64; scratch: (ceil(T/chunk), Q, 2M+1) f64;
// out: (Q, 2M+1) f64.
extern "C" int mpa_launch(const double* mask, const double* meas, int T,
                          int Q, int M, int chunk, double* scratch,
                          double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (M > MAX_M || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0) {
    constexpr int TQ = SNIPPETS_PER_BLOCK;
    dim3 grid(n_chunks, (Q + TQ - 1) / TQ);
    mpa_partials<<<grid, TQ, 0, s>>>(mask, meas, T, Q, M, chunk, scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = Q * (2 * M + 1);
  fms_fold_chunks<<<(n + 255) / 256, 256, 0, s>>>(scratch, n_chunks, n, out);
  return static_cast<int>(cudaGetLastError());
}
