// Fused masked scan for Hopper (sm_90a): the scan of every sample batch.
// This file holds K1 (fms_partials, entry point fms_launch) and K4
// (mpa_partials and mpa_fold, entry point mpa_launch, further down), which
// share the chunked fixed-order fold: K4 keeps K1's chunks, per-tuple
// update and chunk order, so it gives K1's bits on the same block.
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

#include "async_copy.cuh"

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
// bytes (61.4 MB, ~18 us at 3.35 TB/s for T = 60,013 and Q = 128), and does
// ~2(2M+1) operations per mask entry (~1 us of f64 work). At 3.35 TB/s and
// ~0.7 us of memory latency the card needs ~2.3 MB of loads in flight.
//
// Design (redesigned for Hopper: an asynchronous-copy ring per warp):
//  * The fold order is K1's and is not up for trade: for each snippet q the
//    tuples of each FMS chunk (256) are folded in ascending order with K1's
//    per-tuple update on the mask value w (acc_s = fma(w, m, acc_s),
//    acc_q = fma(w, m*m rounded, acc_q), acc_n += w), and the chunks are
//    summed in ascending order from 0.0. On a 0/1 mask built from the same
//    predicates the result is therefore bitwise K1's on the same block,
//    which is what makes a mesh session answer bitwise like a local one.
//  * A warp owns (one chunk) x (a tile of 32 snippets), one lane per
//    snippet; a block is MPA_WARPS such warps on neighbouring snippet tiles
//    of the same chunk, so together they read whole stretches of the same
//    mask rows, and the q tiles vary fastest over the grid. T = 60,013,
//    Q = 128 gives 235 blocks of 4 warps (940 warps), all resident at once.
//  * Each warp streams its (256 x 32) mask slab through its own 4-stage
//    ring of 16-row stages in shared memory, filled with cp.async (16 bytes
//    a lane when Q is even and the mask 16-byte aligned, else 8) and one
//    commit/wait group per stage, so three stages (12 KB a warp, ~11 MB
//    over the card at Q = 128) are in flight while the serial FMA chain
//    runs on the fourth. Warps sync only within themselves.
//  * The chunk's measures reach shared memory once per block, by cp.async
//    in the ring's first group (one block barrier after it lands); m^2 is
//    formed as K1 forms it (__dmul_rn). M is a template argument, so the
//    per-tuple update is straight-line code: once the bytes stream, the
//    warp's serial FMA chain is what a Q = 128 launch waits on, and a
//    loop guarding MAX_M slots at run time makes that chain several
//    times longer.
//  * The ordered sum over chunks is a second launch (mpa_fold): a block
//    copies 32 outputs' partials of up to 256 chunks into shared memory at
//    once (every load in flight), then one lane an output sums them in
//    chunk order. No float atomics.
constexpr int MPA_TILE_Q = 32;   // snippets per warp (lane = snippet)
constexpr int MPA_WARPS = 4;     // warps per block: neighbouring q tiles
constexpr int MPA_ROWS = 16;     // mask rows per ring stage
constexpr int MPA_STAGES = 4;    // ring depth: three stages in flight
constexpr int FOLD_CHUNKS = 256;  // chunks mpa_fold stages at once
constexpr int FOLD_THREADS = 256;
constexpr size_t FOLD_SMEM = sizeof(double) * FOLD_CHUNKS * 32;

template <bool VEC16, int M>
__global__ void __launch_bounds__(MPA_TILE_Q * MPA_WARPS)
    mpa_partials(const double* __restrict__ mask,
                 const double* __restrict__ meas, int T, int Q, int chunk,
                 int n_qb, double* __restrict__ scratch) {
  constexpr int TQ = MPA_TILE_Q;
  constexpr int R = MPA_ROWS;
  constexpr int S = MPA_STAGES;
  extern __shared__ __align__(16) double mpa_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* ring = mpa_smem + warp * S * R * TQ;      // [S][R][TQ]
  double* m_s = mpa_smem + MPA_WARPS * S * R * TQ;  // [chunk][M]

  const int qb = blockIdx.x % n_qb;
  const int c = blockIdx.x / n_qb;
  const int q0 = (qb * MPA_WARPS + warp) * TQ;
  const int q = q0 + lane;
  const int width = min(TQ, Q - q0);  // live snippets of this tile
  const int t_begin = c * chunk;
  const int n_rows = min(chunk, T - t_begin);
  const int n_st = (n_rows + R - 1) / R;
  const double* slab = mask + (size_t)t_begin * Q + q0;

  auto load_stage = [&](int st) {
    double* dst = ring + (st % S) * R * TQ;
    const int r0 = st * R;
    const int nr = min(R, n_rows - r0);
    if constexpr (VEC16) {  // 16 column pairs a row, two rows a pass
      const int pair = lane & 15;
      if (2 * pair < width)
        for (int r = lane >> 4; r < nr; r += 2)
          cp_async<16>(dst + r * TQ + 2 * pair,
                       slab + (size_t)(r0 + r) * Q + 2 * pair);
    } else if (lane < width) {
      for (int r = 0; r < nr; ++r)
        cp_async<8>(dst + r * TQ + lane, slab + (size_t)(r0 + r) * Q + lane);
    }
  };

  const double* mv_g = meas + (size_t)t_begin * M;
  const int tid = threadIdx.x, nthreads = TQ * MPA_WARPS;
  if (VEC16 && (n_rows * M) % 2 == 0) {  // meas 16-byte aligned (launch)
    for (int i = 2 * tid; i < n_rows * M; i += 2 * nthreads)
      cp_async<16>(m_s + i, mv_g + i);
  } else {
    for (int i = tid; i < n_rows * M; i += nthreads)
      cp_async<8>(m_s + i, mv_g + i);
  }
  for (int st = 0; st < S - 1; ++st) {  // the measures ride in group 0
    if (st < n_st) load_stage(st);
    cp_async_commit();
  }

  constexpr int MA = M > 0 ? M : 1;
  double acc_s[MA], acc_q[MA], acc_n = 0.0;
#pragma unroll
  for (int j = 0; j < MA; ++j) acc_s[j] = acc_q[j] = 0.0;

  for (int st = 0; st < n_st; ++st) {  // n_st is the same for every warp
    cp_async_wait<S - 2>();  // stage st has landed (this lane's copies)
    if (st == 0)
      __syncthreads();  // ... and every thread's measures
    else
      __syncwarp();  // ... every lane's, and stage st-1's slot is fully read
    if (st + S - 1 < n_st) load_stage(st + S - 1);
    cp_async_commit();
    const double* w_col = ring + (st % S) * R * TQ + lane;
    const int r0 = st * R;
    const int nr = min(R, n_rows - r0);
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const double w = w_col[r * TQ];
      const double* mv = m_s + (r0 + r) * M;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        acc_s[j] = __fma_rn(w, mv[j], acc_s[j]);
        acc_q[j] = __fma_rn(w, __dmul_rn(mv[j], mv[j]), acc_q[j]);
      }
      acc_n += w;
    }
  }
  cp_async_wait<0>();
  if (q >= Q) return;
  double* dst = scratch + ((size_t)c * Q + q) * (2 * M + 1);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    dst[j] = acc_s[j];
    dst[M + j] = acc_q[j];
  }
  dst[2 * M] = acc_n;
}

using MpaKernel = void (*)(const double*, const double*, int, int, int, int,
                           double*);

template <bool VEC16>
MpaKernel mpa_kernel(int M) {
  switch (M) {
    case 0: return mpa_partials<VEC16, 0>;
    case 1: return mpa_partials<VEC16, 1>;
    case 2: return mpa_partials<VEC16, 2>;
    case 3: return mpa_partials<VEC16, 3>;
    case 4: return mpa_partials<VEC16, 4>;
    case 5: return mpa_partials<VEC16, 5>;
    case 6: return mpa_partials<VEC16, 6>;
    case 7: return mpa_partials<VEC16, 7>;
    default: return mpa_partials<VEC16, MAX_M>;
  }
}

// K4's second pass: out[i] = sum over chunks c = 0, 1, ... of scratch[c, i],
// in that order from 0.0 (fms_fold_chunks' order). A block owns 32 outputs:
// all eight warps copy the chunks' values into shared memory with cp.async
// (every load in flight at once), then warp 0 sums them, one lane an
// output, in chunk order.
__global__ void __launch_bounds__(FOLD_THREADS)
    mpa_fold(const double* __restrict__ scratch, int n_chunks, int n,
             double* __restrict__ out) {
  extern __shared__ __align__(16) double fold_smem[];  // [FOLD_CHUNKS][32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  double s = 0.0;
  for (int c0 = 0; c0 < n_chunks; c0 += FOLD_CHUNKS) {
    const int nc = min(FOLD_CHUNKS, n_chunks - c0);
    if (i < n)
      for (int k = warp; k < nc; k += FOLD_THREADS / 32)
        cp_async<8>(fold_smem + k * 32 + lane,
                    scratch + (size_t)(c0 + k) * n + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0)
      for (int k = 0; k < nc; ++k) s += fold_smem[k * 32 + lane];
    __syncthreads();
  }
  if (warp == 0 && i < n) out[i] = s;
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
// out: (Q, 2M+1) f64. The grid is ceil(T/chunk) * ceil(Q/128) blocks of
// four warps, q tiles fastest (mpa_plan reports it; the wrapper's plan
// mirrors it).
extern "C" int mpa_launch(const double* mask, const double* meas, int T,
                          int Q, int M, int chunk, double* scratch,
                          double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (M > MAX_M || M < 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0) {
    const int width = MPA_TILE_Q * MPA_WARPS;
    const int n_qb = (Q + width - 1) / width;
    const long long blocks = (long long)n_chunks * n_qb;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(double) * (MPA_WARPS * MPA_STAGES * MPA_ROWS *
                                              MPA_TILE_Q +
                                          chunk * M);
    const bool vec16 = Q % 2 == 0 && chunk % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(meas) % 16 == 0;
    const MpaKernel kernel = vec16 ? mpa_kernel<true>(M) : mpa_kernel<false>(M);
    static uint64_t opted_in[2][MAX_M + 1] = {};
    cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(kernel),
                           opted_in[vec16][M]);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(blocks), MPA_TILE_Q * MPA_WARPS, smem,
             s>>>(mask, meas, T, Q, chunk, n_qb, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = Q * (2 * M + 1);
  static uint64_t fold_opted_in = 0;
  cudaError_t e =
      opt_in_smem(reinterpret_cast<const void*>(mpa_fold), fold_opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  mpa_fold<<<(n + 31) / 32, FOLD_THREADS, FOLD_SMEM, s>>>(scratch, n_chunks,
                                                         n, out);
  return static_cast<int>(cudaGetLastError());
}

// K4's launch plan as the launch above computes it, for the wrapper's tests:
// out = {chunks, snippets a block, q tiles of a block's width, partial
// blocks, fold blocks}. Returns 0.
extern "C" int mpa_plan(int T, int Q, int M, int chunk, int* out) {
  const int width = MPA_TILE_Q * MPA_WARPS;
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  const int n_qb = (Q + width - 1) / width;
  out[0] = n_chunks;
  out[1] = width;
  out[2] = n_qb;
  out[3] = n_chunks * n_qb;
  out[4] = (Q * (2 * M + 1) + 31) / 32;
  return 0;
}
