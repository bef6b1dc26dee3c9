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
// bound it (9.6 us); at Q = 128 the operations do: 1.02 GFLOP, 15.3 us on
// the FP64 tensor cores (67 TFLOP/s), twice that on the CUDA cores.
//
// Design (redesigned for Hopper: depth splits, a cp.async ring, DMMA):
//  * gamma2 is linear in each split of the depth of C:
//    sum_c K[q,c] (K Sinv)[q,c] = sum_s sum_c K[q,c] P_s[q,c], with P_s the
//    product over split s. So block (column tile j, depth split s, row tile
//    i) computes the (BM x 64) tile P_s[rows i, cols j] over its split of
//    C's depth, multiplies it by K[rows i, cols j] at once and reduces each
//    row over its 64 columns with a fixed tree (thread, quad shuffle, the
//    eight column groups in order). It writes one gamma partial per (row, j,
//    s); the blocks of split 0 also write the K·alpha partial of (row, j).
//    The split (depth_split) is a function of C alone, never of Q: about
//    264 blocks a row tile (two resident on each of 132 SMs, one wave), at
//    least 64 deep. At C = 2000: 32 column tiles x 8 splits of 256.
//  * Each block streams its K and Sinv sub-blocks through a ring of stages
//    in shared memory (as many as two blocks an SM leave room for, 3 to 8:
//    at C = 2000 in f64, 4 stages 32 deep at Q <= 32 and 3 stages 16 deep
//    at Q = 128), filled with cp.async (16 bytes a copy when C allows, else
//    one element) under one commit/wait group per stage and one barrier per
//    stage; out-of-range rows, columns and depth are zero-filled by the
//    copy itself (src-size 0), so padding adds exact zeros. Rows are padded
//    by 4 elements, which keeps the fragment reads free of bank conflicts.
//  * f64 multiplies on the FP64 tensor cores, mma.sync.m16n8k8 .f64
//    (sm_90; wgmma takes no f64). Two warp tilings of the same kernel:
//    Q > 32 takes "Wide" (128-row blocks, warps 4 x 2, each 32 x 32: 2 x 4
//    fragments), Q <= 32 takes "Narrow" (32-row blocks, warps 1 x 8, each
//    32 x 8), so at the serving shape (Q = 8) all eight warps, on all four
//    sub-partitions, share the product. Fragments whose rows all lie past
//    Q are skipped. Both tilings accumulate each element over k in
//    ascending order and sum each row's 64 columns in one order (eight n8
//    column groups in ascending order), so a row's bits do not depend on
//    the tiling, nor on how many rows ride along.
//  * f32 (use_kernels=True): the same ring, tiles and fragment ownership,
//    with full-precision FFMA in place of DMMA (TF32 would leave the
//    reference's f32 precision).
//  * Second pass (gp_finalize), eight q a block: their partials are copied
//    into shared memory at once, then lane s of q's warp sums split s's
//    column-tile partials in ascending order, lane 0 sums the split sums in
//    ascending order and the K·alpha partials likewise; then the floor and
//    the Eq. 12 blend exactly as the TPU kernel's _finalize. No atomics:
//    every run gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

// The ring is as deep as the blocks an SM holds leave room for (224 KB an
// SM): a stage holds BK of depth of the K rows the block's live warps read
// and of its Sinv columns.
constexpr int MIN_STAGES = 3, MAX_STAGES = 8;
constexpr size_t SMEM_PER_SM = 224 * 1024;
// The depth split: C's own function, never Q's (nor the tiling's). Aim for
// SLOTS blocks of 64 columns (two resident on each of the H100's 132 SMs:
// one wave), each split a multiple of SPLIT_STEP and at least KD_MIN deep.
constexpr int SLOTS = 2 * 132;
constexpr int SLOT_COLS = 64;
constexpr int SPLIT_STEP = 32;  // a multiple of every tiling's BK
constexpr int KD_MIN = 64;

__host__ __device__ constexpr int depth_split(int C) {
  const int n_ct = (C + SLOT_COLS - 1) / SLOT_COLS;
  const int want = n_ct > 0 && SLOTS / n_ct > 1 ? SLOTS / n_ct : 1;
  const int kd =
      ((C + want - 1) / want + SPLIT_STEP - 1) / SPLIT_STEP * SPLIT_STEP;
  return kd > KD_MIN ? kd : KD_MIN;
}

// How the warps of a block share its (BM x BN) tile: WARPS_M x WARPS_N
// warps, each MT x NT fragments of m16 x n8; BK of depth a ring stage, and
// BLOCKS resident on an SM.
template <int WARPS_M_, int MT_, int WARPS_N_, int NT_, int BK_, int BLOCKS_>
struct Tiling {
  static constexpr int WARPS_M = WARPS_M_, MT = MT_;
  static constexpr int WARPS_N = WARPS_N_, NT = NT_;
  static constexpr int BK = BK_, BLOCKS = BLOCKS_;
  static constexpr int WM = 16 * MT, WN = 8 * NT;
  static constexpr int BM = WARPS_M * WM, BN = WARPS_N * WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int GROUPS = BN / 8;  // n8 column groups of a row
  static constexpr int A_LD = BK + 4;    // padded row of the K tile
  static constexpr int B_LD = BN + 4;    // padded row of the Sinv tile
  static constexpr size_t SMEM_BUDGET = SMEM_PER_SM / BLOCKS;
  static_assert(SPLIT_STEP % BK == 0, "a split is whole stages");
};
// Q > 32: 128 x 64 blocks of 8 warps, each 32 x 32, 16 deep a stage, two
// an SM. Q <= 32: 32 x 64 blocks of 8 warps, each 32 x 8, 32 deep a stage,
// so all eight warps share the product at the serving shape.
using Wide = Tiling<4, 2, 2, 4, 16, 2>;
using Narrow = Tiling<1, 2, 8, 1, 32, 2>;

struct Ring {
  int rows;    // K rows a stage holds
  int elems;   // elements a stage holds: the K tile, then Sinv's
  int stages;  // depth of the ring
  size_t bytes;
};

template <typename T, class Tl>
Ring ring_for(int Q) {
  Ring r;
  r.rows = Q >= Tl::BM ? Tl::BM : (Q + Tl::WM - 1) / Tl::WM * Tl::WM;
  r.elems = r.rows * Tl::A_LD + Tl::BK * Tl::B_LD;
  const int fit = static_cast<int>(Tl::SMEM_BUDGET / (sizeof(T) * r.elems));
  r.stages = fit < MIN_STAGES ? MIN_STAGES
                              : (fit > MAX_STAGES ? MAX_STAGES : fit);
  r.bytes = sizeof(T) * r.elems * r.stages;
  return r;
}

// D = A·B + D on the FP64 tensor cores; fragments as PTX's m16n8k8 .f64:
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1] (g = lane/4, t = lane%4).
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4],
                                            double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// One ring stage of a warp's tile: acc[mt][nt] holds the m16n8 fragment
// (mt, nt) in the ownership above. Fragments mt >= mt_live hold only rows
// past Q and are skipped (warp-uniform).
template <int MT, int NT, int BK, int A_LD, int B_LD>
__device__ __forceinline__ void stage_product(const double* a_s,
                                              const double* b_s, int g,
                                              int t, int mt_live,
                                              double (&acc)[MT][NT][4]) {
#pragma unroll
  for (int kb = 0; kb < BK; kb += 8) {
    double a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < mt_live) {
        const double* r = a_s + (mt * 16 + g) * A_LD + kb + t;
        a[mt][0] = r[0];
        a[mt][1] = r[8 * A_LD];
        a[mt][2] = r[4];
        a[mt][3] = r[8 * A_LD + 4];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const double* c = b_s + (kb + t) * B_LD + nt * 8 + g;
      const double b0 = c[0], b1 = c[4 * B_LD];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < mt_live) dmma_16x8x8(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// f32: the same fragments, full-precision FFMA, k in ascending order.
template <int MT, int NT, int BK, int A_LD, int B_LD>
__device__ __forceinline__ void stage_product(const float* a_s,
                                              const float* b_s, int g, int t,
                                              int mt_live,
                                              float (&acc)[MT][NT][4]) {
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float lo[MT], hi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      lo[mt] = a_s[(mt * 16 + g) * A_LD + k];
      hi[mt] = a_s[(mt * 16 + g + 8) * A_LD + k];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b =
          *reinterpret_cast<const float2*>(b_s + k * B_LD + nt * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mt_live) {
          acc[mt][nt][0] = fmaf(lo[mt], b.x, acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(lo[mt], b.y, acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(hi[mt], b.x, acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(hi[mt], b.y, acc[mt][nt][3]);
        }
      }
    }
  }
}

// VEC elements per cp.async: 16 bytes when every row of K and Sinv starts
// 16-byte aligned (C a multiple of VEC, aligned pointers), else 1.
template <typename T, int VEC, class Tl>
__global__ void __launch_bounds__(Tl::THREADS, Tl::BLOCKS)
    gp_partials(const T* __restrict__ K, const T* __restrict__ S,
                const T* __restrict__ alpha, int Q, int C, int KD,
                int ring_rows, int stages, T* __restrict__ part_g,
                T* __restrict__ part_t) {
  constexpr int MT = Tl::MT, NT = Tl::NT, WM = Tl::WM, WN = Tl::WN;
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK;
  constexpr int A_LD = Tl::A_LD, B_LD = Tl::B_LD;
  constexpr int THREADS = Tl::THREADS, GROUPS = Tl::GROUPS;
  extern __shared__ __align__(16) unsigned char gp_smem[];
  T* ring = reinterpret_cast<T*>(gp_smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  const int ct = blockIdx.x, split = blockIdx.y;
  const int n_ct = gridDim.x, n_splits = gridDim.y;
  const int row0 = blockIdx.z * BM, col0 = ct * BN;
  const int k_begin = split * KD;
  const int k_end = min(C, k_begin + KD);
  const int n_st = (k_end - k_begin + BK - 1) / BK;
  const int wrow0 = row0 + wm * WM;
  const bool active = wrow0 < Q;  // warp-uniform
  const int mt_live = active ? min(MT, (Q - wrow0 + 15) / 16) : 0;
  // K rows that an active warp reads: a warp's rows, up to the last one
  // that holds a live row (the others are never read, so never filled).
  const int rows_used = min(BM, (Q - row0 + WM - 1) / WM * WM);

  const int stage_elems = ring_rows * A_LD + BK * B_LD;
  auto load_stage = [&](int st) {
    T* a_s = ring + (st % stages) * stage_elems;
    T* b_s = a_s + ring_rows * A_LD;
    const int k0 = k_begin + st * BK;
    for (int i = tid; i < rows_used * BK / VEC; i += THREADS) {
      const int r = i / (BK / VEC), kk = (i % (BK / VEC)) * VEC;
      const int row = row0 + r, k = k0 + kk;
      const bool ok = row < Q && k < k_end;
      cp_async<static_cast<int>(VEC * sizeof(T))>(
          a_s + r * A_LD + kk, ok ? K + (size_t)row * C + k : K, ok);
    }
    for (int i = tid; i < BK * BN / VEC; i += THREADS) {
      const int kk = i / (BN / VEC), n = (i % (BN / VEC)) * VEC;
      const int k = k0 + kk, col = col0 + n;
      const bool ok = k < k_end && col < C;
      cp_async<static_cast<int>(VEC * sizeof(T))>(
          b_s + kk * B_LD + n, ok ? S + (size_t)k * C + col : S, ok);
    }
  };

  T acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = T(0);

  for (int st = 0; st < stages - 1; ++st) {
    if (st < n_st) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();  // stage st landed; stage st-1's slot is fully read
    if (st + stages - 1 < n_st) load_stage(st + stages - 1);
    cp_async_commit();
    if (active) {
      const T* a_s = ring + (st % stages) * stage_elems;
      stage_product<MT, NT, BK, A_LD, B_LD>(a_s + wm * WM * A_LD,
                            a_s + ring_rows * A_LD + wn * WN, g, t, mt_live,
                            acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the row reduction

  // Each row's sum over the tile's BN columns, in a fixed order: per n8
  // column group, the thread's two columns in order, then the quad's four
  // threads by a fixed shuffle tree; then the groups in ascending order.
  T* red_g = ring;                // [GROUPS][BM]
  T* red_t = ring + GROUPS * BM;  // [GROUPS][BM]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_live) continue;  // warp-uniform
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * WM + mt * 16 + g + 8 * h;
      const int row = row0 + rl;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        T gs = T(0), ts = T(0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wn * WN + nt * 8 + 2 * t + e;
          const bool ok = row < Q && col < C;
          const T kv = ok ? K[(size_t)row * C + col] : T(0);
          gs = fma(acc[mt][nt][2 * h + e], kv, gs);
          if (split == 0) ts = fma(kv, col < C ? alpha[col] : T(0), ts);
        }
        gs += __shfl_xor_sync(0xffffffffu, gs, 1);
        gs += __shfl_xor_sync(0xffffffffu, gs, 2);
        ts += __shfl_xor_sync(0xffffffffu, ts, 1);
        ts += __shfl_xor_sync(0xffffffffu, ts, 2);
        if (t == 0) {
          red_g[(wn * NT + nt) * BM + rl] = gs;
          red_t[(wn * NT + nt) * BM + rl] = ts;
        }
      }
    }
  }
  __syncthreads();
  for (int rl = tid; rl < BM; rl += THREADS) {
    const int row = row0 + rl;
    if (row >= Q) continue;
    T gs = red_g[rl], ts = red_t[rl];
#pragma unroll
    for (int j = 1; j < GROUPS; ++j) {
      gs += red_g[j * BM + rl];
      ts += red_t[j * BM + rl];
    }
    part_g[((size_t)row * n_ct + ct) * n_splits + split] = gs;
    if (split == 0) part_t[(size_t)row * n_ct + ct] = ts;
  }
}

// Second pass. A block owns FIN_Q consecutive q (one warp each); part_g
// (Q, n_ct, n_splits) and part_t (Q, n_ct) hold each q's partials in one
// contiguous run, which all the block's threads copy into shared memory at
// once (cp.async, every load in flight). Then lane s of q's warp sums split
// s's column-tile partials in ascending order, lane 0 the K·alpha
// partials, and lane 0 sums the split sums in ascending order.
constexpr int FIN_Q = 8;
constexpr int FIN_THREADS = 32 * FIN_Q;

template <typename T>
__global__ void __launch_bounds__(FIN_THREADS)
    gp_finalize(const T* __restrict__ part_g, const T* __restrict__ part_t,
                int n_ct, int n_splits, int Q, const T* __restrict__ kappa2,
                const T* __restrict__ mu, const T* __restrict__ rawt,
                const T* __restrict__ rawb, T* __restrict__ theta,
                T* __restrict__ beta2, T* __restrict__ gamma2) {
  extern __shared__ __align__(16) unsigned char fin_smem[];
  T* sg = reinterpret_cast<T*>(fin_smem);        // [FIN_Q][n_ct][n_splits]
  T* st = sg + (size_t)FIN_Q * n_ct * n_splits;  // [FIN_Q][n_ct]
  const int q0 = blockIdx.x * FIN_Q;
  const int nq = min(FIN_Q, Q - q0);
  const int per_q = n_ct * n_splits;
  for (int i = threadIdx.x; i < nq * per_q; i += FIN_THREADS)
    cp_async<static_cast<int>(sizeof(T))>(sg + i,
                                          part_g + (size_t)q0 * per_q + i);
  for (int i = threadIdx.x; i < nq * n_ct; i += FIN_THREADS)
    cp_async<static_cast<int>(sizeof(T))>(st + i,
                                          part_t + (size_t)q0 * n_ct + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (w >= nq) return;  // warp-uniform
  const int q = q0 + w;
  const T* pg = sg + (size_t)w * per_q;
  T g = T(0), tk = T(0);
  for (int base = 0; base < n_splits; base += 32) {
    const int s = base + lane;
    T ss = T(0);
    if (s < n_splits)
      for (int j = 0; j < n_ct; ++j) ss += pg[j * n_splits + s];
    for (int j = 0; j < 32; ++j) {
      const T v = __shfl_sync(0xffffffffu, ss, j);
      if (base + j < n_splits) g += v;
    }
  }
  if (lane != 0) return;
  for (int j = 0; j < n_ct; ++j) tk += st[w * n_ct + j];
  const T gam = max(kappa2[q] - g, T(1e-30));
  const T prior = mu[q] + tk;
  const T rb = rawb[q], rt = rawt[q];
  const T denom = rb + gam;
  const bool exact = rb <= T(0);
  theta[q] = exact ? rt : (rb * prior + gam * rt) / denom;
  beta2[q] = exact ? T(0) : rb * gam / denom;
  gamma2[q] = gam;
}

template <typename T, int VEC, class Tl>
cudaError_t launch_tiled(const T* K, const T* S, const T* alpha, int Q,
                            int C, int KD, T* part_g, T* part_t,
                            cudaStream_t s) {
  static uint64_t opted_in = 0;  // devices this instance may use smem on
  cudaError_t e = opt_in_smem(
      reinterpret_cast<const void*>(gp_partials<T, VEC, Tl>), opted_in);
  if (e != cudaSuccess) return e;
  const Ring ring = ring_for<T, Tl>(Q);
  dim3 grid((C + Tl::BN - 1) / Tl::BN, (C + KD - 1) / KD,
            (Q + Tl::BM - 1) / Tl::BM);
  gp_partials<T, VEC, Tl><<<grid, Tl::THREADS, ring.bytes, s>>>(
      K, S, alpha, Q, C, KD, ring.rows, ring.stages, part_g, part_t);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_partials(const T* K, const T* S, const T* alpha, int Q,
                            int C, int KD, T* part_g, T* part_t,
                            cudaStream_t s) {
  return Q <= Narrow::BM
             ? launch_tiled<T, VEC, Narrow>(K, S, alpha, Q, C, KD, part_g,
                                            part_t, s)
             : launch_tiled<T, VEC, Wide>(K, S, alpha, Q, C, KD, part_g,
                                          part_t, s);
}

template <typename T>
int gp_launch(const T* K, const T* S, const T* alpha, const T* kappa2,
              const T* mu, const T* rawt, const T* rawb, int Q, int C,
              T* part_g, T* part_t, T* theta, T* beta2, T* gamma2,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (C < 0 || (Q + Wide::BM - 1) / Wide::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int KD = depth_split(C);
  const int BN = Q <= Narrow::BM ? Narrow::BN : Wide::BN;
  const int n_ct = (C + BN - 1) / BN, n_splits = (C + KD - 1) / KD;
  if (C > 0) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = C % VEC == 0 &&
                     reinterpret_cast<uintptr_t>(K) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(S) % 16 == 0;
    cudaError_t e =
        vec ? launch_partials<T, VEC>(K, S, alpha, Q, C, KD, part_g, part_t, s)
            : launch_partials<T, 1>(K, S, alpha, Q, C, KD, part_g, part_t, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static uint64_t fin_opted_in = 0;
  cudaError_t e =
      opt_in_smem(reinterpret_cast<const void*>(gp_finalize<T>), fin_opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t fin_smem = sizeof(T) * FIN_Q * n_ct * (n_splits + 1);
  gp_finalize<T><<<(Q + FIN_Q - 1) / FIN_Q, FIN_THREADS, fin_smem, s>>>(
      part_g, part_t, n_ct, n_splits, Q, kappa2, mu, rawt, rawb, theta, beta2,
      gamma2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Both passes run on `stream`;
// nothing is allocated here; the return value is cudaGetLastError().
// part_g: (Q, ceil(C/64), ceil(C/128)) and part_t: (Q, ceil(C/64)) scratch
// of the same type (gp_plan reports the tiling).
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

// The launch plan the entry points use, for the wrapper's tests:
// out = {row tile, column tile, depth split, row tiles, column tiles,
// splits, shared-memory bytes a block (f64), ring stages (f64)}. Returns 0.
extern "C" int gp_plan(int Q, int C, int* out) {
  const bool narrow = Q <= Narrow::BM;
  const int BM = narrow ? Narrow::BM : Wide::BM;
  const int BN = narrow ? Narrow::BN : Wide::BN;
  out[0] = BM;
  out[1] = BN;
  const int KD = depth_split(C);
  out[2] = KD;
  out[3] = (Q + BM - 1) / BM;
  out[4] = (C + BN - 1) / BN;
  out[5] = (C + KD - 1) / KD;
  const Ring ring = narrow ? ring_for<double, Narrow>(Q)
                           : ring_for<double, Wide>(Q);
  out[6] = static_cast<int>(ring.bytes);
  out[7] = ring.stages;
  return 0;
}
