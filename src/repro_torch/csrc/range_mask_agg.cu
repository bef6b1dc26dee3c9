// Range-mask aggregation for Hopper (sm_90a), in float32.
//
// Replaces the TPU kernel src/repro/kernels/range_mask_agg/kernel.py
// (_rma_kernel, launched by range_mask_agg_pallas). For each snippet q and
// payload column p it computes, over the tuples t of one block,
//
//     out[q, p] = sum_t mask[t, q] * extra[t, q] * payload[t, p]
//     mask[t, q] = AND_k (lo[q,k] - eps <= x[t,k] <= hi[q,k] + eps)
//
// all in float32, as the reference does: x, lo and hi arrive as float32, the
// widened bounds lo - eps and hi + eps are rounded to float32 before the
// compare, and the sums accumulate in float32. `extra` is the (T, Q) mask the
// caller builds outside the kernel (categorical membership times validity).
//
// What bounds it on the H100: bytes. It reads the f32 extra mask once,
// T*Q*4 bytes (30.7 MB, ~9 us at 3.35 TB/s for T = 60,000 and Q = 128),
// and does ~2(L + P) operations per (tuple, snippet) pair (~2 us).
//
// Design: as the fused scan's (csrc/fused_masked_scan.cu). One thread owns
// one snippet, so the threads of a warp read neighbouring q of one row of
// `extra` (coalesced); tuples and their payload are staged through shared
// memory and read by the whole warp at once (a broadcast). Block (chunk c,
// snippet tile) folds its chunk's tuples in ascending order into
// scratch[c, q, :]; a second pass sums the chunks in ascending order. The
// result is the same bits on every run: no float atomics. A launch folds at
// most MAX_P = 17 payload columns (kept in registers); the wrapper folds
// more in launches over groups of at most 17, each reading its columns in
// place (the payload pointer at the group's first column, the full row
// stride) and writing its own columns of the output. A column's bits do
// not depend on the columns that ride along.
#include <cuda_runtime.h>

namespace {

constexpr int SNIPPETS_PER_BLOCK = 128;  // TQ: one thread per snippet
constexpr int TUPLES_PER_TILE = 128;     // tuples staged in shared memory
constexpr int MAX_P = 17;                // payload columns kept in registers

__global__ void rma_partials(const float* __restrict__ x,
                             const float* __restrict__ payload, int ps,
                             const float* __restrict__ lo,
                             const float* __restrict__ hi,
                             const float* __restrict__ extra, int T, int Q,
                             int L, int P, int chunk, float eps,
                             float* __restrict__ scratch) {
  constexpr int TQ = SNIPPETS_PER_BLOCK;
  constexpr int TT = TUPLES_PER_TILE;
  extern __shared__ __align__(16) float smem[];
  float* lo_s = smem;           // [L][TQ]
  float* hi_s = lo_s + L * TQ;  // [L][TQ]
  float* x_s = hi_s + L * TQ;   // [TT][L]
  float* p_s = x_s + TT * L;    // [TT][P]

  const int tid = threadIdx.x;
  const int q = blockIdx.y * TQ + tid;
  const bool live = q < Q;
  const int t_begin = blockIdx.x * chunk;
  const int t_end = min(T, t_begin + chunk);

  for (int k = 0; k < L; ++k) {
    lo_s[k * TQ + tid] = live ? __fsub_rn(lo[(size_t)q * L + k], eps) : 0.0f;
    hi_s[k * TQ + tid] = live ? __fadd_rn(hi[(size_t)q * L + k], eps) : 0.0f;
  }

  float acc[MAX_P];
#pragma unroll
  for (int j = 0; j < MAX_P; ++j) acc[j] = 0.0f;

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    __syncthreads();  // the previous tile is fully read
    for (int i = tid; i < n * L; i += TQ) x_s[i] = x[(size_t)t0 * L + i];
    for (int i = tid; i < n * P; i += TQ)
      p_s[i] = payload[(size_t)(t0 + i / P) * ps + i % P];
    __syncthreads();
    if (!live) continue;
    const float* col = extra + (size_t)t0 * Q + q;
    for (int t = 0; t < n; ++t) {
      bool hit = true;
      for (int k = 0; k < L; ++k) {
        const float xv = x_s[t * L + k];
        hit = hit && (xv >= lo_s[k * TQ + tid]) && (xv <= hi_s[k * TQ + tid]);
      }
      const float w = hit ? col[(size_t)t * Q] : 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_P; ++j) {
        if (j < P) acc[j] = __fmaf_rn(w, p_s[t * P + j], acc[j]);
      }
    }
  }
  if (!live) return;
  float* dst = scratch + ((size_t)blockIdx.x * Q + q) * P;
#pragma unroll
  for (int j = 0; j < MAX_P; ++j) {
    if (j < P) dst[j] = acc[j];
  }
}

// out[q, p] (rows `os` apart) = sum over chunks c = 0, 1, ... of
// scratch[c, q, p], in that order, for the P columns of one group.
__global__ void rma_fold_chunks(const float* __restrict__ scratch,
                                int n_chunks, int Q, int P, int os,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = Q * P;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, scratch[(size_t)c * n + i]);
  out[(size_t)(i / P) * os + i % P] = s;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches both passes on `stream`,
// allocates nothing, and returns cudaGetLastError().
// x: (T, L); payload: the group's first of P <= 17 columns, rows
// `payload_stride` apart; lo/hi: (Q, L); extra: (T, Q), all f32; scratch:
// (ceil(T/chunk), Q, P) f32; out: the group's first column of the output,
// rows `out_stride` apart.
extern "C" int rma_launch(const float* x, const float* payload,
                          int payload_stride, const float* lo,
                          const float* hi, const float* extra, int T, int Q,
                          int L, int P, int chunk, float eps, float* scratch,
                          float* out, int out_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (P > MAX_P || P <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0) {
    constexpr int TQ = SNIPPETS_PER_BLOCK;
    constexpr int TT = TUPLES_PER_TILE;
    const size_t smem = sizeof(float) * (2 * L * TQ + TT * L + TT * P);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          rma_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid(n_chunks, (Q + TQ - 1) / TQ);
    rma_partials<<<grid, TQ, smem, s>>>(x, payload, payload_stride, lo, hi,
                                         extra, T, Q, L, P, chunk, eps,
                                         scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = Q * P;
  rma_fold_chunks<<<(n + 255) / 256, 256, 0, s>>>(scratch, n_chunks, Q, P,
                                                   out_stride, out);
  return static_cast<int>(cudaGetLastError());
}
