// Fused masked scan for Hopper (sm_90a): the scan of every sample batch.
// This file holds K1 (fms_partials, fms_partials_any and
// fms_partials_stream with its word pass fms_words, entry point fms_launch) and K4 (mpa_partials, entry
// point mpa_launch, further down).
// Both fold in one fixed order and share the second pass (mpa_fold), so K4
// gives K1's bits on the same block.
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
// The fold order, K1's and K4's, is not up for trade. The tuples are cut
// into chunks of `chunk` (256). For each snippet and column the tuples of a
// chunk are folded in ascending order from 0.0 with the mask value w:
// acc_s = fma(w, m, acc_s), acc_q = fma(w, m*m rounded, acc_q), acc_n += w.
// The second pass sums the chunks in ascending order from 0.0. The order
// depends on T alone: every run gives the same bits, a snippet's row does
// not depend on Q or on which snippets ride along, and a measure's columns
// do not depend on which measures ride along. A launch folds at most
// MAX_M = 8 measures (the kernels are templated on M); the wrapper folds
// more in launches over groups of at most 8 consecutive measures, each
// reading its group in place (the measures pointer at the group's first
// column, the full row stride) and writing its own columns of the output.
// No float atomics anywhere.
//
// What bounds K1 on the H100: instruction issue, not bytes. Per (tuple,
// snippet) pair it does 2L f64 compares and 2M+1 f64 adds (both on the FP64
// pipe), C membership tests and a select, against ~T(8L + 4C + 8M + 8)
// bytes read once (3.4 MB at T = 60,000 and the main path's widths, ~1 us).
// The main path's stage loop issues ~34 instructions a tuple a warp
// (cuobjdump -sass; ~55 for 64 snippets at 2 a lane). At the serving shape
// (T = 60,000, Q = 128) the fixed fold order allows 940 warps, 1.8 a
// scheduler, so latency, not issue, is what the launch waits on.
//
// Design (redesigned for Hopper):
//  * A warp owns (one chunk) x (a tile of 32 SPL snippets), SPL snippets a
//    lane; a block is FMS_WARPS such warps on neighbouring snippet tiles of
//    the same chunk, the tiles varying fastest over the grid (K4's grid).
//    Warps sync only within themselves. SPL is 1 at the serving shape
//    (Q = 128 gives only 940 warps: the card needs every one) and 2 where
//    the grid is wide (one broadcast tuple then feeds two chains, and a
//    warp's ring serves twice the snippets: half the shared memory and
//    loads a snippet).
//  * Per snippet, everything that does not depend on the tuple lives in
//    registers: lo - eps and hi + eps of up to FMS_LB = 4 numeric dims, and
//    the category set of each of up to FMS_CB = 4 categorical dims as a bit
//    word (32 bits when V <= 32, 64 when V <= 64), tested as
//    (word >> code) & 1. Fewer dims are padded with neutral ones (x = 0
//    against [-inf, inf], code 0 against the word 1), so one instantiation
//    serves every L <= 4 and C <= 4. M is a template argument, so the
//    per-tuple update is straight-line code.
//  * Tuples stream through a per-warp ring of FMS_STAGES stages of
//    FMS_ROWS tuples in shared memory, filled with cp.async (one group a
//    stage; lane i copies tuple i of the stage), so FMS_STAGES - 1 stages
//    are in flight while the warp folds one. A staged tuple is one record
//    [x (4), m (M), m^2 (M), valid] of doubles read as 16-byte broadcasts,
//    and its codes one 16-byte word. m^2 is formed once per tuple
//    (__dmul_rn, K4's and the plain version's rounding) by the lane that
//    copied it when its stage lands, which also zeroes the weight of a
//    tuple with a code outside [0, V). The category words' shifted bits are
//    ANDed before bit 0 is tested (an AND the compiler cannot see into:
//    left to itself it tests each word's bit apart, 3 instructions a dim).
//    A ragged stage is zero-filled, and a zero tuple adds exactly nothing
//    (fma(0, 0, acc) == acc; acc is never -0), so every stage folds all
//    FMS_ROWS tuples unrolled.
//  * The snippets' category sets (Q x C x V bytes) reach shared memory in
//    the ring's first group and become bit words there.
//  * The ordered sum over chunks is K4's second pass (mpa_fold).
//  * Other shapes (L > 4, C > 4 or V > 64) take fms_partials_any, the same
//    skeleton and fold (below); shapes whose staging outgrows a block's
//    shared memory take fms_partials_stream. No width is refused.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int MAX_M = 8;       // measures one launch folds (templated)
constexpr int FMS_WARPS = 4;   // warps a block: neighbouring snippet tiles
constexpr int FMS_SPL_WIDE = 2;  // snippets a lane on a wide grid
constexpr int FMS_WIDE_WARPS = 16;  // ... when it gives an SM this many warps
constexpr int FMS_RK = 1;      // tuples a lane copies into a stage
constexpr int FMS_ROWS = 32 * FMS_RK;    // tuples a ring stage
constexpr int FMS_STAGES = 3;  // ring depth: FMS_STAGES - 1 in flight
constexpr int FMS_LB = 4;      // numeric dims in registers (padded)
constexpr int FMS_CB = 4;      // categorical dims in registers (padded)
constexpr int FMS_VMAX = 64;   // values of a categorical dim in a bit word
static_assert(FMS_CB == 4, "a tuple's codes are one int4");

// The staged record of one tuple, in doubles: x [0, LB), m [LB, LB + M),
// m^2 [LB + M, LB + 2M), valid at LB + 2M; an even size (16-byte pairs).
template <int M>
struct Rec {
  static constexpr int X = 0, MV = FMS_LB, MQ = FMS_LB + M, V = FMS_LB + 2 * M;
  static constexpr int SIZE = (FMS_LB + 2 * M + 2) / 2 * 2;
};

// a & b, opaque to the compiler, so that it tests bit 0 of the AND of the
// shifted category words once instead of each word's bit apart.
__device__ __forceinline__ uint32_t and_opaque(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("and.b32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint64_t and_opaque(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("and.b64 %0, %1, %2;" : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// Load a staged record (16-byte aligned, of an even size) as 16-byte pairs.
template <int SIZE>
__device__ __forceinline__ void load_record(const double* rec,
                                            double (&f)[SIZE]) {
#pragma unroll
  for (int e = 0; e < SIZE / 2; ++e) {
    const double2 d = reinterpret_cast<const double2*>(rec)[e];
    f[2 * e] = d.x;
    f[2 * e + 1] = d.y;
  }
}

// Shared memory of one warp of fms_partials<M>: the ring's records, its
// codes and the warp's category sets (C * V bytes a snippet).
__host__ __device__ inline size_t fms_warp_smem(int m, int c, int v,
                                                int spl) {
  const size_t rec = (FMS_LB + 2 * m + 2) / 2 * 2;
  const size_t cat = ((size_t)32 * spl * c * v + 15) / 16 * 16;
  return FMS_STAGES * FMS_ROWS * (rec * sizeof(double) + FMS_CB * sizeof(int))
         + cat;
}

template <int M, int VW, int SPL>
__global__ void __launch_bounds__(32 * FMS_WARPS)
    fms_partials(const double* __restrict__ x, const int* __restrict__ codes,
                 const double* __restrict__ valid,
                 const double* __restrict__ meas, int ms,
                 const double* __restrict__ lo, const double* __restrict__ hi,
                 const uint8_t* __restrict__ cat, int T, int Q, int L, int C,
                 int V, int chunk, int n_qb, double eps,
                 double* __restrict__ scratch) {
  using R = Rec<M>;
  using Word = std::conditional_t<VW == 1, uint32_t, uint64_t>;
  constexpr int RW = FMS_ROWS;
  constexpr int S = FMS_STAGES;
  constexpr int MA = M > 0 ? M : 1;
  extern __shared__ __align__(16) unsigned char fms_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qb = blockIdx.x % n_qb;
  const int c = blockIdx.x / n_qb;
  constexpr int TILE = 32 * SPL;  // snippets a warp
  const int q0 = (qb * FMS_WARPS + warp) * TILE;
  if (q0 >= Q) return;  // no live snippet (the warp syncs with no other)
  const int n_live = min(TILE, Q - q0);
  unsigned char* base = fms_smem + warp * fms_warp_smem(M, C, V, SPL);
  double* ring = reinterpret_cast<double*>(base);  // [S][RW][SIZE]
  int* cring = reinterpret_cast<int*>(ring + S * RW * R::SIZE);  // [S][RW][4]
  uint8_t* cat_s = reinterpret_cast<uint8_t*>(cring + S * RW * FMS_CB);

  const int t_begin = c * chunk;
  const int n_rows = min(chunk, T - t_begin);
  const int n_st = (n_rows + RW - 1) / RW;

  // Fields no copy writes: the padded numeric and categorical dims.
  for (int e = lane; e < S * RW; e += 32) {
    for (int k = L; k < FMS_LB; ++k) ring[e * R::SIZE + R::X + k] = 0.0;
    for (int k = C; k < FMS_CB; ++k) cring[e * FMS_CB + k] = 0;
  }
  // The tile's category sets, in the ring's first group.
  const uint8_t* cat_g = cat + (size_t)q0 * C * V;
  const int nb = n_live * C * V;
  int plain_from = 0;
  if ((reinterpret_cast<uintptr_t>(cat_g) & 3) == 0) {
    for (int w = lane; w < nb / 4; w += 32)
      cp_async<4>(cat_s + 4 * w, cat_g + 4 * w);
    plain_from = nb / 4 * 4;
  }
  for (int b = plain_from + lane; b < nb; b += 32) cat_s[b] = cat_g[b];

  auto load_stage = [&](int st) {
    if (st >= n_st) return;
    double* rs = ring + (st % S) * RW * R::SIZE;
    int* cs = cring + (st % S) * RW * FMS_CB;
#pragma unroll
    for (int rk = 0; rk < FMS_RK; ++rk) {
      const int i = lane + 32 * rk;
      const int r = st * RW + i;
      const bool in = r < n_rows;
      const size_t t = in ? (size_t)(t_begin + r) : 0;  // a row that exists
      double* rec = rs + i * R::SIZE;
#pragma unroll
      for (int k = 0; k < FMS_LB; ++k)
        if (k < L) cp_async<8>(rec + R::X + k, x + t * L + k, in);
#pragma unroll
      for (int j = 0; j < M; ++j)
        cp_async<8>(rec + R::MV + j, meas + t * ms + j, in);
      if (valid)
        cp_async<8>(rec + R::V, valid + t, in);
      else
        rec[R::V] = in ? 1.0 : 0.0;
#pragma unroll
      for (int k = 0; k < FMS_CB; ++k)
        if (k < C) cp_async<4>(cs + i * FMS_CB + k, codes + t * C + k, in);
    }
  };
  // This lane's tuples of stage st have landed: form m^2, and zero the
  // weight (and codes) of a tuple with a code outside [0, V).
  auto land_stage = [&](int st) {
    double* rs = ring + (st % S) * RW * R::SIZE;
    int* cs = cring + (st % S) * RW * FMS_CB;
#pragma unroll
    for (int rk = 0; rk < FMS_RK; ++rk) {
      const int i = lane + 32 * rk;
      double* rec = rs + i * R::SIZE;
#pragma unroll
      for (int j = 0; j < M; ++j)
        rec[R::MQ + j] = __dmul_rn(rec[R::MV + j], rec[R::MV + j]);
      bool bad = false;
#pragma unroll
      for (int k = 0; k < FMS_CB; ++k)
        bad |= k < C && (unsigned)cs[i * FMS_CB + k] >= (unsigned)V;
      if (bad) {
        rec[R::V] = 0.0;
#pragma unroll
        for (int k = 0; k < FMS_CB; ++k) cs[i * FMS_CB + k] = 0;
      }
    }
  };

  for (int st = 0; st < S - 1; ++st) {  // the category sets ride in group 0
    load_stage(st);
    cp_async_commit();
  }

  // Per snippet: the widened bounds and the category words.
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double lo_r[SPL][FMS_LB], hi_r[SPL][FMS_LB];
  Word word[SPL][FMS_CB];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int q = q0 + lane + 32 * s;
#pragma unroll
    for (int k = 0; k < FMS_LB; ++k) {
      const bool use = k < L && q < Q;
      lo_r[s][k] = use ? lo[(size_t)q * L + k] - eps : -inf;
      hi_r[s][k] = use ? hi[(size_t)q * L + k] + eps : inf;
    }
  }
  cp_async_wait<S - 2>();
  land_stage(0);
  __syncwarp();  // every lane's copies of stage 0 and of the sets
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int ls = lane + 32 * s;
#pragma unroll
    for (int k = 0; k < FMS_CB; ++k) {
      Word w = 1;  // a padded dim: code 0, a member
      if (k < C) {
        w = 0;
        if (ls < n_live)
          for (int v = 0; v < V; ++v)
            w |= Word(cat_s[(ls * C + k) * V + v] != 0) << v;
      }
      word[s][k] = w;
    }
  }

  double acc_s[SPL][MA], acc_q[SPL][MA], acc_n[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    acc_n[s] = 0.0;
#pragma unroll
    for (int j = 0; j < MA; ++j) acc_s[s][j] = acc_q[s][j] = 0.0;
  }

  for (int st = 0; st < n_st; ++st) {
    load_stage(st + S - 1);  // into stage st - 1's slot, read by now
    cp_async_commit();
    const double* rs = ring + (st % S) * RW * R::SIZE;
    const int* cs = cring + (st % S) * RW * FMS_CB;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const double* rec = rs + i * R::SIZE;
      double f[R::SIZE];
      load_record(rec, f);
      const int4 cd = *reinterpret_cast<const int4*>(cs + i * FMS_CB);
      const unsigned code[FMS_CB] = {(unsigned)cd.x, (unsigned)cd.y,
                                     (unsigned)cd.z, (unsigned)cd.w};
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        bool hit = true;
#pragma unroll
        for (int k = 0; k < FMS_LB; ++k)
          hit = hit & (f[R::X + k] >= lo_r[s][k]) &
                (f[R::X + k] <= hi_r[s][k]);
        Word bits = word[s][0] >> code[0];
#pragma unroll
        for (int k = 1; k < FMS_CB; ++k)
          bits = and_opaque(bits, word[s][k] >> code[k]);
        const double w = (hit && (bits & 1)) ? f[R::V] : 0.0;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          acc_s[s][j] = __fma_rn(w, f[R::MV + j], acc_s[s][j]);
          acc_q[s][j] = __fma_rn(w, f[R::MQ + j], acc_q[s][j]);
        }
        acc_n[s] = __dadd_rn(acc_n[s], w);
      }
    }
    if (st + 1 < n_st) {
      cp_async_wait<S - 2>();  // stage st + 1 has landed (this lane's)
      land_stage(st + 1);
      __syncwarp();  // ... every lane's, and stage st is fully read
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int q = q0 + lane + 32 * s;
    if (q >= Q) continue;
    double* dst = scratch + ((size_t)c * Q + q) * (2 * M + 1);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      dst[j] = acc_s[s][j];
      dst[M + j] = acc_q[s][j];
    }
    dst[2 * M] = acc_n[s];
  }
}

// K1 at any width (L > FMS_LB, C > FMS_CB or V > FMS_VMAX): the register
// path's skeleton and fold, with what the shape forces changed.
//
// What bounds it: instruction issue and latency. Per (tuple, snippet) pair
// it does 2L f64 compares (2 * FMS_ANY_LR with the padded dims) and 2M + 1
// f64 adds; at L = 9, M = 8 the tuple loop issues ~101 instructions a
// tuple a warp, 44 of them on the FP64 pipe (two issue cycles each: 16
// FP64 lanes a scheduler), and the serving shape's 940 warps are 1.8 a
// scheduler.
//
// Design (redesigned for Hopper):
//  * A warp owns (one chunk) x (a tile of 32 snippets), one lane a snippet;
//    a block is up to FMS_WARPS such warps on neighbouring tiles of one
//    chunk (fewer where the shape's staging needs more shared memory).
//  * Tuples stream through a per-warp ring of FMS_STAGES stages of FMS_ROWS
//    records [x (L, padded to at least FMS_ANY_LR and to an even count),
//    (m_j, m_j^2) pairs (M), valid, pad] of doubles (a stride that spreads
//    the lanes' copies over the banks), filled with cp.async
//    (lane i copies tuple i), and their codes (C, padded to 4) beside them.
//    m^2 is formed once a tuple (__dmul_rn) by the lane that copied it when
//    its stage lands, which also zeroes the weight of a tuple with a code
//    outside [0, V): the loop then tests no code's range.
//  * Bounds: the widened bounds (lo - eps, hi + eps, formed once) of the
//    first FMS_ANY_LR dims stay in registers (padded dims compare x = 0
//    against [-inf, inf]); the rest sit in shared memory as a (lo, hi)
//    pair a lane a dim, [dim][lane], read as one 16-byte load.
//  * Categories: where the register path's words hold them (C <= 4 and
//    V <= 64: VW 1 or 2, 32- or 64-bit words), they are those words, in
//    registers, tested the same way. Else (VW 0) each snippet's set of each
//    dim becomes ceil(V/32) 32-bit words in shared memory, [dim][word][lane]
//    (a lane's word of a dim is bank-conflict free), tested as
//    (word[code >> 5] >> (code & 31)) & 1. A loop over dims in the tuple
//    loop (shared-memory bounds, VW 0) holds each tuple's loads behind the
//    last one's: the registers keep the common shapes free of it.
//  * The predicate is straight-line: the compares and the category bits
//    are ANDed with no early exit, so the lanes never diverge.
//  * M is a template argument (at most MAX_M a launch); the fold is K1's:
//    fma(w, m, acc), fma(w, m^2, acc), acc_n += w over each chunk in
//    ascending order from 0.0, then mpa_fold. A ragged stage is zero-filled
//    and adds exactly nothing, as on the register path.
constexpr int FMS_ANY_LR = 10;  // numeric dims whose bounds sit in registers

// The x slots of an any-width record: L padded to FMS_ANY_LR, even.
__host__ __device__ inline int any_lx(int L) {
  return (max(L, FMS_ANY_LR) + 1) / 2 * 2;
}
// The category words of the any-width path: 1 or 2 (32- or 64-bit words in
// registers, as the register path's), 0 (words in shared memory).
__host__ __device__ inline int any_vw(int C, int V) {
  if (C > FMS_CB) return 0;
  if (C == 0 || V <= 32) return 1;
  return V <= FMS_VMAX ? 2 : 0;
}
// Doubles of an any-width record: x, the (m, m^2) pairs, valid and a pad,
// even (16-byte pairs) and not a multiple of 4, so that the lanes' 8-byte
// copies into their records spread over the banks (a stride of 32 words
// would put every lane on one bank).
__host__ __device__ inline int any_rec(int L, int M) {
  const int size = any_lx(L) + 2 * M + 2;
  return size % 4 ? size : size + 2;
}
// Codes a tuple holds in the ring (an int4 when the words are registers).
__host__ __device__ inline int any_cp(int C, int V) {
  return any_vw(C, V) ? FMS_CB : (C + 3) / 4 * 4;
}
// 32-bit words of one category set (at least one: a dim of no values).
__host__ __device__ inline int any_nw(int V) { return max(1, (V + 31) / 32); }

// Shared memory of one warp of fms_partials_any<M, VW>: its ring of
// records and codes, the bounds past the registers and the category words.
__host__ __device__ inline size_t fms_any_warp_smem(int m, int l, int c,
                                                    int v) {
  const size_t rec = any_rec(l, m);
  return FMS_STAGES * FMS_ROWS * (rec * sizeof(double) + any_cp(c, v) * 4) +
         (size_t)max(l - FMS_ANY_LR, 0) * 32 * 2 * sizeof(double) +
         (any_vw(c, v) ? 0 : (size_t)c * any_nw(v) * 32 * sizeof(uint32_t));
}

template <int M, int VW>
__global__ void __launch_bounds__(32 * FMS_WARPS)
    fms_partials_any(const double* __restrict__ x,
                     const int* __restrict__ codes,
                     const double* __restrict__ valid,
                     const double* __restrict__ meas, int ms,
                     const double* __restrict__ lo,
                     const double* __restrict__ hi,
                     const uint8_t* __restrict__ cat, int T, int Q, int L,
                     int C, int V, int chunk, int n_qb, double eps,
                     double* __restrict__ scratch) {
  constexpr int LR = FMS_ANY_LR;
  constexpr int RW = FMS_ROWS;
  constexpr int S = FMS_STAGES;
  constexpr int MA = M > 0 ? M : 1;
  static_assert(LR % 2 == 0, "register dims are read as pairs");
  using Word = std::conditional_t<VW == 2, uint64_t, uint32_t>;
  extern __shared__ __align__(16) unsigned char fms_smem[];
  const int n_warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qb = blockIdx.x % n_qb;
  const int c = blockIdx.x / n_qb;
  const int q0 = (qb * n_warps + warp) * 32;
  if (q0 >= Q) return;  // no live snippet (the warp syncs with no other)
  const int n_live = min(32, Q - q0);
  const int q = q0 + lane;
  const int LX = any_lx(L), SIZE = any_rec(L, M), CP = any_cp(C, V);
  const int NW = any_nw(V), LS = max(L - LR, 0);
  unsigned char* base = fms_smem + warp * fms_any_warp_smem(M, L, C, V);
  double* ring = reinterpret_cast<double*>(base);  // [S][RW][SIZE]
  int* cring = reinterpret_cast<int*>(ring + S * RW * SIZE);  // [S][RW][CP]
  double2* bnd = reinterpret_cast<double2*>(cring + S * RW * CP);  // [LS][32]
  uint32_t* words = reinterpret_cast<uint32_t*>(bnd + LS * 32);  // [C][NW][32]

  const int t_begin = c * chunk;
  const int n_rows = min(chunk, T - t_begin);
  const int n_st = (n_rows + RW - 1) / RW;

  // The x slots no copy writes (dims L .. LX - 1): zero, against [-inf,
  // inf]; so are the padded codes of register words (code 0, word 1).
  for (int e = lane; e < S * RW; e += 32) {
    for (int k = L; k < LX; ++k) ring[e * SIZE + k] = 0.0;
    for (int k = C; k < CP; ++k) cring[e * CP + k] = 0;
  }

  auto load_stage = [&](int st) {
    if (st >= n_st) return;
    const int r = st * RW + lane;
    const bool in = r < n_rows;
    const size_t t = in ? (size_t)(t_begin + r) : 0;  // a row that exists
    double* rec = ring + ((st % S) * RW + lane) * SIZE;
    int* cs = cring + ((st % S) * RW + lane) * CP;
    for (int k = 0; k < L; ++k) cp_async<8>(rec + k, x + t * L + k, in);
#pragma unroll
    for (int j = 0; j < M; ++j)
      cp_async<8>(rec + LX + 2 * j, meas + t * ms + j, in);
    if (valid)
      cp_async<8>(rec + LX + 2 * M, valid + t, in);
    else
      rec[LX + 2 * M] = in ? 1.0 : 0.0;
    for (int k = 0; k < C; ++k) cp_async<4>(cs + k, codes + t * C + k, in);
  };
  // This lane's tuple of stage st has landed: form m^2, and zero the weight
  // (and codes) of a tuple with a code outside [0, V).
  auto land_stage = [&](int st) {
    double* rec = ring + ((st % S) * RW + lane) * SIZE;
    int* cs = cring + ((st % S) * RW + lane) * CP;
#pragma unroll
    for (int j = 0; j < M; ++j)
      rec[LX + 2 * j + 1] = __dmul_rn(rec[LX + 2 * j], rec[LX + 2 * j]);
    bool bad = false;
    for (int k = 0; k < C; ++k) bad |= (unsigned)cs[k] >= (unsigned)V;
    if (bad) {
      rec[LX + 2 * M] = 0.0;
      for (int k = 0; k < C; ++k) cs[k] = 0;
    }
  };

  for (int st = 0; st < S - 1; ++st) {
    load_stage(st);
    cp_async_commit();
  }

  // Per snippet, formed once: the widened bounds (registers, then shared
  // memory) and the category words.
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const bool live = lane < n_live;
  double lo_r[LR], hi_r[LR];
#pragma unroll
  for (int k = 0; k < LR; ++k) {
    const bool use = k < L && live;
    lo_r[k] = use ? lo[(size_t)q * L + k] - eps : -inf;
    hi_r[k] = use ? hi[(size_t)q * L + k] + eps : inf;
  }
  for (int k = 0; k < LS; ++k)
    bnd[k * 32 + lane] =
        live ? make_double2(lo[(size_t)q * L + LR + k] - eps,
                            hi[(size_t)q * L + LR + k] + eps)
             : make_double2(-inf, inf);
  Word word_r[FMS_CB];  // VW 1, 2: the register path's words
#pragma unroll
  for (int k = 0; k < FMS_CB; ++k) {
    Word w = 1;  // a padded dim: code 0, a member
    if (VW && k < C) {
      w = 0;
      if (live)
        for (int v = 0; v < V; ++v)
          w |= Word(cat[((size_t)q * C + k) * V + v] != 0) << v;
    }
    word_r[k] = w;
  }
  if (!VW)
    for (int i = lane; i < C * NW * 32; i += 32) {
      const int s = i % 32, kw = i / 32, k = kw / NW, w0 = kw % NW * 32;
      uint32_t word = 0;
      if (s < n_live) {
        const uint8_t* set = cat + ((size_t)(q0 + s) * C + k) * V;
        for (int b = 0; b < 32 && w0 + b < V; ++b)
          word |= uint32_t(set[w0 + b] != 0) << b;
      }
      words[i] = word;
    }
  cp_async_wait<S - 2>();
  land_stage(0);
  __syncwarp();  // every lane's copies of stage 0, bounds and words

  double acc_s[MA], acc_q[MA], acc_n = 0.0;
#pragma unroll
  for (int j = 0; j < MA; ++j) acc_s[j] = acc_q[j] = 0.0;

  for (int st = 0; st < n_st; ++st) {
    load_stage(st + S - 1);  // into stage st - 1's slot, read by now
    cp_async_commit();
    const double* rs = ring + (st % S) * RW * SIZE;
    const int* cs = cring + (st % S) * RW * CP;
#pragma unroll 4
    for (int i = 0; i < RW; ++i) {
      const double* rec = rs + i * SIZE;
      // Each pair of dims' four compares apart, the pairs ANDed as a tree
      // the compiler cannot chain (left to itself it feeds every compare's
      // predicate into the next: a serial chain of 2 LR DSETPs a tuple).
      uint32_t ok[LR / 2];
#pragma unroll
      for (int k = 0; k < LR; k += 2) {
        const double2 xv = reinterpret_cast<const double2*>(rec)[k / 2];
        ok[k / 2] = (xv.x >= lo_r[k]) & (xv.x <= hi_r[k]) &
                    (xv.y >= lo_r[k + 1]) & (xv.y <= hi_r[k + 1]);
      }
#pragma unroll
      for (int n = LR / 2; n > 1; n = (n + 1) / 2)
#pragma unroll
        for (int j = 0; j < n / 2; ++j)
          ok[j] = and_opaque(ok[j], ok[n - 1 - j]);
      bool hit = ok[0];
#pragma unroll 1
      for (int k = 0; k < LS; ++k) {
        const double xv = rec[LR + k];
        const double2 b = bnd[k * 32 + lane];
        hit = hit & (xv >= b.x) & (xv <= b.y);
      }
      bool member;
      if constexpr (VW != 0) {
        const int4 cd = *reinterpret_cast<const int4*>(cs + i * CP);
        const Word bits = and_opaque(
            and_opaque(word_r[0] >> cd.x, word_r[1] >> cd.y),
            and_opaque(word_r[2] >> cd.z, word_r[3] >> cd.w));
        member = bits & 1;
      } else {
        uint32_t bits = 1;
#pragma unroll 1
        for (int k = 0; k < C; ++k) {
          const unsigned code = static_cast<unsigned>(cs[i * CP + k]);
          bits &= words[(k * NW + (code >> 5)) * 32 + lane] >> (code & 31);
        }
        member = bits & 1;
      }
      const double w = (hit && member) ? rec[LX + 2 * M] : 0.0;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const double2 mv = reinterpret_cast<const double2*>(rec + LX)[j];
        acc_s[j] = __fma_rn(w, mv.x, acc_s[j]);
        acc_q[j] = __fma_rn(w, mv.y, acc_q[j]);
      }
      acc_n = __dadd_rn(acc_n, w);
    }
    if (st + 1 < n_st) {
      cp_async_wait<S - 2>();  // stage st + 1 has landed (this lane's)
      land_stage(st + 1);
      __syncwarp();  // ... every lane's, and stage st is fully read
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  double* dst = scratch + ((size_t)c * Q + q) * (2 * M + 1);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    dst[j] = acc_s[j];
    dst[M + j] = acc_q[j];
  }
  dst[2 * M] = acc_n;
}

// K1 for shapes whose any-width staging outgrows a block's shared memory
// even at one warp (about L > 150 dims, or C * V past ~48,000 category
// values, e.g. a categorical dim of 30,000 values): fms_partials_stream.
//
// What bounds it: each warp's passes over its chunk, instruction issue and
// latency (at Q = 128, T = 60,000: 940 warps, 8 a block on 120 SMs), and
// the word pass's reads of the sets (15.4 MB at C = 4, V = 30,000). Its
// earlier per-lane form read each snippet's category byte where it lay: a
// 32-sector gather a tuple at L2 latency, behind compares that left early.
//
// Design (redesigned for Hopper):
//  * A first pass (fms_words) turns the (Q, C, V) bytes into 32-bit words
//    laid out [tile][dim][word][lane] (32 snippets a tile, a lane a
//    snippet), the any-width path's layout, into a scratch the wrapper
//    allocates: a warp's membership test is then one conflict-free
//    shared-memory load a tuple.
//  * A block is one 32-snippet tile and FMS_G_WARPS warps, each on its own
//    chunk (the tiles vary fastest over the grid, so neighbouring blocks
//    read the same tuples): the tile's words are staged once for all of
//    them. They are streamed a slice of FMS_G_SLICE words at a time, and
//    only up to the word of the largest code the block's tuples hold for
//    the dim, so no V, C or L is refused.
//  * Each lane keeps its hits for the 256 tuples of its warp's chunk as a
//    256-bit mask in registers across the passes: the range compares of
//    each numeric dim (bounds widened once, held in registers while the
//    dim's pass runs), then each categorical dim's slices; a tuple's code
//    outside [0, V) clears its bit for every lane (a ballot). Each pass
//    loads a column of the chunk lane-parallel (8 tuples a lane) and
//    broadcasts a tuple at a time by shuffle. The predicate is
//    straight-line: no compare leaves early.
//  * The fold is K1's: fma(w, m, acc), fma(w, m^2, acc), acc_n += w over
//    the chunk's tuples in ascending order from 0.0, w the tuple's weight
//    (valid, or 1) where its bit is set, else 0; then mpa_fold. So the
//    counts are exact and the sums are the other paths' bits.
constexpr int FMS_G_WARPS = 8;      // chunks (warps) a block on one tile
constexpr int FMS_G_SLICE = 1536;   // category words of a tile staged at once
constexpr int FMS_G_ROWS = 256;     // tuples a hit mask covers (8 words)
constexpr int FMS_G_COL = FMS_G_ROWS * sizeof(double);  // a staged column
constexpr int FMS_G_HITS = FMS_G_ROWS * sizeof(uint32_t);  // a warp's masks
static_assert(FMS_G_SLICE * 128 + FMS_G_WARPS * (FMS_G_COL + FMS_G_HITS)
                  <= 227 * 1024, "path 3's shared memory");

// Path 3's dynamic shared memory: the words of a slice, or (after the
// category passes) each warp's fold columns [valid, m_0 .. m_{M-1}]; each
// warp's staged column of the chunk; each warp's hit masks.
__host__ __device__ inline size_t fms_stream_smem(int M, int C, int V) {
  const size_t words = (size_t)(C ? min(any_nw(V), FMS_G_SLICE) : 1) * 128;
  const size_t fold = (size_t)FMS_G_WARPS * (M + 1) * FMS_G_COL;
  return (words > fold ? words : fold) +
         (size_t)FMS_G_WARPS * (FMS_G_COL + FMS_G_HITS);
}

// The category words of 32-snippet tiles, [tile][dim][word][lane]: a warp
// a (tile, dim, word), one snippet's 32 bytes a ballot (a coalesced load).
__global__ void __launch_bounds__(256)
    fms_words(const uint8_t* __restrict__ cat, int Q, int C, int V, int NW,
              long long n_words, uint32_t* __restrict__ words) {
  const long long wid = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid * 32 >= n_words) return;  // uniform over the warp
  const int w = static_cast<int>(wid % NW);
  const long long tk = wid / NW;
  const int k = static_cast<int>(tk % C);
  const long long q0 = tk / C * 32;
  const int v = w * 32 + lane;
  uint32_t mine = 0;
#pragma unroll  // every snippet's load in flight at once
  for (int s = 0; s < 32; ++s) {
    const long long q = q0 + s;
    const bool in = q < Q && v < V;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, in && cat[((size_t)q * C + k) * V + v]);
    if (lane == s) mine = bits;
  }
  words[wid * 32 + lane] = mine;
}

template <int M>
__global__ void __launch_bounds__(32 * FMS_G_WARPS)
    fms_partials_stream(const double* __restrict__ x,
                        const int* __restrict__ codes,
                        const double* __restrict__ valid,
                        const double* __restrict__ meas, int ms,
                        const double* __restrict__ lo,
                        const double* __restrict__ hi,
                        const uint32_t* __restrict__ words, int T, int Q,
                        int L, int C, int V, int chunk, int n_chunks,
                        int n_tiles, double eps,
                        double* __restrict__ scratch) {
  constexpr int MA = M > 0 ? M : 1;
  constexpr int G = FMS_G_ROWS / 32;  // mask words: tuples g * 32 + tt
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char fms_smem[];
  __shared__ int block_max[FMS_G_WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t big = fms_stream_smem(M, C, V) -
                     (size_t)FMS_G_WARPS * (FMS_G_COL + FMS_G_HITS);
  uint32_t* words_s = reinterpret_cast<uint32_t*>(fms_smem);  // [w][lane]
  double* fold_s = reinterpret_cast<double*>(fms_smem) +
                   (size_t)warp * (M + 1) * FMS_G_ROWS;  // [M + 1][rows]
  double* col_d = reinterpret_cast<double*>(fms_smem + big) +
                  (size_t)warp * FMS_G_ROWS;  // this warp's column
  int* col_i = reinterpret_cast<int*>(col_d);
  uint32_t* hits = reinterpret_cast<uint32_t*>(
      fms_smem + big + (size_t)FMS_G_WARPS * FMS_G_COL) + warp * 32 * G;
  const int tile = blockIdx.x % n_tiles;
  const int c = blockIdx.x / n_tiles * FMS_G_WARPS + warp;  // this warp's
  const int q = tile * 32 + lane;
  const int NW = max(1, (V + 31) / 32);
  const int t_begin = c * chunk;
  const int n_rows = c < n_chunks ? min(chunk, T - t_begin) : 0;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);

  double acc_s[MA], acc_q[MA], acc_n = 0.0;
#pragma unroll
  for (int j = 0; j < MA; ++j) acc_s[j] = acc_q[j] = 0.0;

  // Sub-chunks of FMS_G_ROWS tuples (one, at the port's chunk of 256), in
  // order, on the same accumulators: the order of the chunk's tuples.
  for (int sub = 0; sub < chunk; sub += FMS_G_ROWS) {  // uniform
    const int t0 = t_begin + sub;
    const int rows = max(0, min(FMS_G_ROWS, n_rows - sub));
    for (int g = 0; g < G; ++g) {  // bit tt of word g: tuple g * 32 + tt
      const int n = min(32, max(0, rows - 32 * g));
      hits[g * 32 + lane] = n == 32 ? FULL : (1u << n) - 1u;
    }
    // The range of each numeric dim: the chunk's column staged, then each
    // tuple's value read by every lane at once.
    for (int k = 0; k < L; ++k) {
      const double lo_k = q < Q ? lo[(size_t)q * L + k] - eps : -inf;
      const double hi_k = q < Q ? hi[(size_t)q * L + k] + eps : inf;
      __syncwarp();  // the last column is read
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int r = 32 * g + lane;
        col_d[r] = r < rows ? x[(size_t)(t0 + r) * L + k] : 0.0;
      }
      __syncwarp();
#pragma unroll 1
      for (int g = 0; g < G; ++g) {
        uint32_t keep = 0;
#pragma unroll
        for (int tt = 0; tt < 32; ++tt) {
          const double v = col_d[32 * g + tt];
          keep |= uint32_t((v >= lo_k) & (v <= hi_k)) << tt;
        }
        hits[g * 32 + lane] &= keep;
      }
    }
    // Each categorical dim, its words a slice at a time (only up to the
    // word of the largest code the block's tuples hold).
    for (int k = 0; k < C; ++k) {
      int mx = -1;  // the largest code in [0, V) of the warp's tuples
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int r = 32 * g + lane;
        const int cd = r < rows ? codes[(size_t)(t0 + r) * C + k] : 0;
        const bool bad = r < rows && (unsigned)cd >= (unsigned)V;
        col_i[r] = cd;
        hits[g * 32 + lane] &= ~__ballot_sync(FULL, bad);
        if (r < rows && !bad) mx = max(mx, cd);
      }
      mx = __reduce_max_sync(FULL, mx);
      __syncthreads();  // the last slice, fold columns and maxima are read
      if (lane == 0) block_max[warp] = mx;
      __syncthreads();
      for (int w = 0; w < FMS_G_WARPS; ++w) mx = max(mx, block_max[w]);
      const int nw = mx < 0 ? 0 : (mx >> 5) + 1;  // words any tuple reads
      const uint32_t* set = words + ((size_t)tile * C + k) * NW * 32;
      if (nw == 1) {  // every code below 32: one word a lane
        const uint32_t word = set[lane];
#pragma unroll 1
        for (int g = 0; g < G; ++g) {
          uint32_t keep = 0;
#pragma unroll
          for (int tt = 0; tt < 32; ++tt)
            keep |= ((word >> (col_i[32 * g + tt] & 31)) & 1u) << tt;
          hits[g * 32 + lane] &= keep;
        }
        continue;
      }
      for (int w0 = 0; w0 < nw; w0 += FMS_G_SLICE) {  // uniform
        const int nws = min(FMS_G_SLICE, nw - w0);
        if (w0 > 0) __syncthreads();  // the last slice is read
        for (int i = threadIdx.x; i < nws * 8; i += 32 * FMS_G_WARPS)
          cp_async<16>(words_s + 4 * i, set + (size_t)w0 * 32 + 4 * i);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll 1
        for (int g = 0; g < G; ++g) {
          uint32_t keep = 0;
#pragma unroll
          for (int tt = 0; tt < 32; ++tt) {
            const unsigned code = (unsigned)col_i[32 * g + tt];
            const unsigned wi = (code >> 5) - (unsigned)w0;
            const uint32_t word =
                wi < (unsigned)nws ? words_s[wi * 32 + lane] : FULL;
            keep |= ((word >> (code & 31)) & 1u) << tt;
          }
          hits[g * 32 + lane] &= keep;
        }
      }
    }
    // The fold: the warp's columns [valid, m_0 ..] staged where the words
    // were, then every tuple of the sub-chunk in order.
    __syncthreads();  // every warp is done with the words
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = 32 * g + lane;
      const bool in = r < rows;
      const size_t t = (size_t)(t0 + (in ? r : 0));
      fold_s[r] = in ? (valid ? valid[t] : 1.0) : 0.0;
#pragma unroll
      for (int j = 0; j < M; ++j)
        fold_s[(j + 1) * FMS_G_ROWS + r] = in ? meas[t * ms + j] : 0.0;
    }
    __syncwarp();
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      const uint32_t h = hits[g * 32 + lane];
#pragma unroll
      for (int tt = 0; tt < 32; ++tt) {
        const int r = 32 * g + tt;
        const double w = (h >> tt) & 1u ? fold_s[r] : 0.0;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const double m = fold_s[(j + 1) * FMS_G_ROWS + r];
          acc_s[j] = __fma_rn(w, m, acc_s[j]);
          acc_q[j] = __fma_rn(w, __dmul_rn(m, m), acc_q[j]);
        }
        acc_n = __dadd_rn(acc_n, w);
      }
    }
  }
  if (c >= n_chunks || q >= Q) return;
  double* dst = scratch + ((size_t)c * Q + q) * (2 * M + 1);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    dst[j] = acc_s[j];
    dst[M + j] = acc_q[j];
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
//  * The fold order is K1's (above): on a 0/1 mask built from the same
//    predicates the result is bitwise K1's on the same block, which is what
//    makes a mesh session answer bitwise like a local one.
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
//    times longer. Above 8 measures the wrapper launches over groups of at
//    most 8, as for K1 (the measures read in place with their row stride).
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
                 const double* __restrict__ meas, int ms, int T, int Q,
                 int chunk, int n_qb, double* __restrict__ scratch) {
  constexpr int TQ = MPA_TILE_Q;
  constexpr int R = MPA_ROWS;
  constexpr int S = MPA_STAGES;
  constexpr int MA = M > 0 ? M : 1;
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

  const double* mv_g = meas + (size_t)t_begin * ms;
  const int tid = threadIdx.x, nthreads = TQ * MPA_WARPS;
  if (ms == M && VEC16 && (n_rows * M) % 2 == 0) {  // 16-byte aligned
    for (int i = 2 * tid; i < n_rows * M; i += 2 * nthreads)
      cp_async<16>(m_s + i, mv_g + i);
  } else if (ms == M) {
    for (int i = tid; i < n_rows * M; i += nthreads)
      cp_async<8>(m_s + i, mv_g + i);
  } else {  // a group of wider measures: rows of ms, M of them read
    for (int i = tid; i < n_rows * M; i += nthreads)
      cp_async<8>(m_s + i, mv_g + (size_t)(i / MA) * ms + i % MA);
  }
  for (int st = 0; st < S - 1; ++st) {  // the measures ride in group 0
    if (st < n_st) load_stage(st);
    cp_async_commit();
  }

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

// The second pass of K1 and K4: for each of the Q (2g+1) columns of a
// group of g measures, the sum over chunks c = 0, 1, ... of scratch[c, i],
// in that order from 0.0, written to the group's own column of the (Q,
// 2 m_out + 1) output ([m, m^2, 1] order; col0 the group's first measure).
// A block owns 32 outputs: all eight warps copy the chunks' values into
// shared memory with cp.async (every load in flight at once), then warp 0
// sums them, one lane an output, in chunk order.
__global__ void __launch_bounds__(FOLD_THREADS)
    mpa_fold(const double* __restrict__ scratch, int n_chunks, int Q, int g,
             int col0, int m_out, double* __restrict__ out) {
  extern __shared__ __align__(16) double fold_smem[];  // [FOLD_CHUNKS][32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = 2 * g + 1;
  const int n = Q * P;
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
  if (warp == 0 && i < n) {
    const int q = i / P, j = i % P;
    const int col = j < g ? col0 + j
                          : (j < 2 * g ? m_out + col0 + (j - g) : 2 * m_out);
    out[(size_t)q * (2 * m_out + 1) + col] = s;
  }
}

int launch_fold(const double* scratch, int n_chunks, int Q, int g, int col0,
                int m_out, double* out, cudaStream_t s) {
  static uint64_t opted_in = 0;
  cudaError_t e =
      opt_in_smem(reinterpret_cast<const void*>(mpa_fold), opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = Q * (2 * g + 1);
  mpa_fold<<<(n + 31) / 32, FOLD_THREADS, FOLD_SMEM, s>>>(
      scratch, n_chunks, Q, g, col0, m_out, out);
  return static_cast<int>(cudaGetLastError());
}

using FmsKernel = void (*)(const double*, const int*, const double*,
                           const double*, int, const double*, const double*,
                           const uint8_t*, int, int, int, int, int, int, int,
                           double, double*);

// Run CALL with the constant M equal to the run-time m (0..MAX_M).
#define WITH_M(m, CALL)                              \
  switch (m) {                                       \
    case 0: { constexpr int M = 0; return CALL; }    \
    case 1: { constexpr int M = 1; return CALL; }    \
    case 2: { constexpr int M = 2; return CALL; }    \
    case 3: { constexpr int M = 3; return CALL; }    \
    case 4: { constexpr int M = 4; return CALL; }    \
    case 5: { constexpr int M = 5; return CALL; }    \
    case 6: { constexpr int M = 6; return CALL; }    \
    case 7: { constexpr int M = 7; return CALL; }    \
    default: { constexpr int M = 8; return CALL; }   \
  }
static_assert(MAX_M == 8, "WITH_M lists m = 0..8");

// Shared memory a block may opt into (227 KB).
constexpr size_t SMEM_OPT_IN = 227 * 1024;

// K1's path for a shape: 1 the register path with 32-bit category words,
// 2 with 64-bit words, 0 fms_partials_any, 3 fms_partials_stream (a shape
// whose any-width staging outgrows a block's shared memory at one warp).
int fms_path(int L, int C, int V, int M) {
  if (L <= FMS_LB && C <= FMS_CB) {
    if (C == 0 || V <= 32) return 1;
    if (V <= FMS_VMAX) return 2;
  }
  return fms_any_warp_smem(M, L, C, V) <= SMEM_OPT_IN ? 0 : 3;
}

// Warps a block: FMS_WARPS, on path 3 FMS_G_WARPS (chunks of one tile),
// and on the any-width path the most (4, 2 or 1) whose staging fits a
// block's shared memory.
int fms_warps(int path, int L, int C, int V, int M) {
  if (path == 3) return FMS_G_WARPS;
  if (path != 0) return FMS_WARPS;
  int w = FMS_WARPS;
  while (w > 1 && w * fms_any_warp_smem(M, L, C, V) > SMEM_OPT_IN) w /= 2;
  return w;
}

// Snippets a lane: FMS_SPL_WIDE on the register path when that grid still
// gives every SM FMS_WIDE_WARPS warps (a wide Q: one broadcast tuple then
// feeds more chains), else 1 (a small Q needs every warp it can get).
int fms_spl(int path, int n_chunks, int Q, int n_sm) {
  const long long tiles = (Q + 32 * FMS_SPL_WIDE - 1) / (32 * FMS_SPL_WIDE);
  return (path == 1 || path == 2) &&
                 (long long)n_chunks * tiles >= (long long)FMS_WIDE_WARPS * n_sm
             ? FMS_SPL_WIDE
             : 1;
}

// Dynamic shared memory a block of the path takes.
size_t fms_block_smem(int path, int spl, int warps, int L, int C, int V,
                      int M) {
  if (path == 1 || path == 2) return FMS_WARPS * fms_warp_smem(M, C, V, spl);
  if (path == 0) return warps * fms_any_warp_smem(M, L, C, V);
  return fms_stream_smem(M, C, V);
}

// 32-bit words of path 3's category scratch: [tile][dim][word][lane].
long long fms_word_count(int path, int Q, int C, int V) {
  if (path != 3) return 0;
  return (long long)((Q + 31) / 32) * C * any_nw(V) * 32;
}

FmsKernel fms_kernel(int path, int spl, int m, int vw) {
  if (path == 1 && spl == 1) WITH_M(m, (fms_partials<M, 1, 1>))
  if (path == 1) WITH_M(m, (fms_partials<M, 1, FMS_SPL_WIDE>))
  if (path == 2 && spl == 1) WITH_M(m, (fms_partials<M, 2, 1>))
  if (path == 2) WITH_M(m, (fms_partials<M, 2, FMS_SPL_WIDE>))
  if (path == 0 && vw == 1) WITH_M(m, (fms_partials_any<M, 1>))
  if (path == 0 && vw == 2) WITH_M(m, (fms_partials_any<M, 2>))
  WITH_M(m, (fms_partials_any<M, 0>))
}

using FmsStreamKernel = void (*)(const double*, const int*, const double*,
                                 const double*, int, const double*,
                                 const double*, const uint32_t*, int, int,
                                 int, int, int, int, int, int, double,
                                 double*);

FmsStreamKernel fms_stream_kernel(int m) {
  WITH_M(m, (fms_partials_stream<M>))
}

// Path 3: the word pass, then the tile's warps over their chunks.
int launch_stream(const double* x, const int* codes, const double* valid,
                  const double* meas, int ms, const double* lo,
                  const double* hi, const uint8_t* cat, int T, int Q, int L,
                  int C, int V, int M, int chunk, int n_chunks, double eps,
                  uint32_t* words, double* scratch, cudaStream_t s) {
  const long long n_words = fms_word_count(3, Q, C, V);
  if (n_words > 0) {
    if (!words) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (n_words / 32 + 7) / 8;  // a warp a word row
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    fms_words<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        cat, Q, C, V, any_nw(V), n_words, words);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_tiles = (Q + 31) / 32;
  const long long blocks =
      (long long)n_tiles * ((n_chunks + FMS_G_WARPS - 1) / FMS_G_WARPS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const FmsStreamKernel kernel = fms_stream_kernel(M);
  const size_t smem = fms_block_smem(3, 1, FMS_G_WARPS, L, C, V, M);
  // The most this kernel asks (a full slice or M = 8's fold columns): a
  // kernel with static shared memory may not opt into all 227 KB.
  static uint64_t opted_in[MAX_M + 1] = {};
  cudaError_t e = opt_in_smem(
      reinterpret_cast<const void*>(kernel), opted_in[M],
      static_cast<int>(fms_stream_smem(MAX_M, 1, FMS_G_SLICE * 32)));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), 32 * FMS_G_WARPS, smem, s>>>(
      x, codes, valid, meas, ms, lo, hi, words, T, Q, L, C, V, chunk,
      n_chunks, n_tiles, eps, scratch);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, read once a device (K1 asks on every
// launch).
int sm_count() {
  static int n_sm[64] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && n_sm[dev]) return n_sm[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) n_sm[dev] = n;
  return n;
}

using MpaKernel = void (*)(const double*, const double*, int, int, int, int,
                           int, double*);

template <bool VEC16>
MpaKernel mpa_kernel(int m) {
  WITH_M(m, (mpa_partials<VEC16, M>))
}

}  // namespace

// Plain C entry point of K1 (bound with ctypes). Launches both passes on
// `stream`, allocates nothing, and returns cudaGetLastError().
// x: (T, L) f64; codes: (T, C) i32; valid: (T,) f64 or null (every tuple
// valid); meas: the group's first of M <= 8 measures, rows `meas_stride`
// apart; lo/hi: (Q, L) f64; cat: (Q, C, V) bytes (bool); scratch:
// (ceil(T/chunk), Q, 2M+1) f64; words: path 3's category words, as many
// 32-bit words as fms_plan reports (null on the other paths); out: (Q,
// 2 m_out + 1) f64, of which the group writes the columns of measures
// col0 .. col0 + M - 1 and the count.
extern "C" int fms_launch(const double* x, const int* codes,
                          const double* valid, const double* meas,
                          int meas_stride, const double* lo, const double* hi,
                          const uint8_t* cat, int T, int Q, int L, int C,
                          int V, int M, int col0, int m_out, int chunk,
                          double eps, double* scratch, uint32_t* words,
                          double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (M < 0 || M > MAX_M || chunk <= 0 || col0 < 0 || col0 + M > m_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0 && fms_path(L, C, V, M) == 3) {
    const int e = launch_stream(x, codes, valid, meas, meas_stride, lo, hi,
                                cat, T, Q, L, C, V, M, chunk, n_chunks, eps,
                                words, scratch, s);
    if (e) return e;
  } else if (n_chunks > 0) {
    const int path = fms_path(L, C, V, M);
    const int spl = fms_spl(path, n_chunks, Q, sm_count());
    const int warps = fms_warps(path, L, C, V, M);
    const int width = 32 * spl * warps;
    const int n_qb = (Q + width - 1) / width;
    const long long blocks = (long long)n_chunks * n_qb;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int vw = path == 0 ? any_vw(C, V) : 0;
    const FmsKernel kernel = fms_kernel(path, spl, M, vw);
    const size_t smem = fms_block_smem(path, spl, warps, L, C, V, M);
    if (smem) {
      static uint64_t opted_in[3][3][MAX_M + 1] = {};  // paths 0-2
      cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(kernel),
                                  opted_in[path][path ? spl > 1 : vw][M]);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem, s>>>(
        x, codes, valid, meas, meas_stride, lo, hi, cat, T, Q, L, C, V,
        chunk, n_qb, eps, scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return launch_fold(scratch, n_chunks, Q, M, col0, m_out, out, s);
}

// K1's launch plan as the launch above computes it on the current device,
// for the wrapper's fused_scan_plan: out = {path (0 any width, 1 32-bit
// category words, 2 64-bit, 3 any width with streamed category words),
// snippets a lane, snippets a block, chunks, q tiles, partial blocks, fold
// blocks, dynamic shared memory a block, the device's SMs, tuples a ring
// stage, the any-width path's category words (1 or 2: 32- or 64-bit words
// in registers, 0: in shared memory or another path), path 3's 32-bit
// category words (0 on the others), chunks a block}. Returns 0.
extern "C" int fms_plan(int T, int Q, int M, int L, int C, int V, int chunk,
                        int* out) {
  const int path = fms_path(L, C, V, M);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  const int n_sm = sm_count();
  const int spl = fms_spl(path, n_chunks, Q, n_sm);
  const int warps = fms_warps(path, L, C, V, M);
  // Path 3: a block is one tile of 32 snippets and `warps` chunks.
  const int width = path == 3 ? 32 : 32 * spl * warps;
  const int per_block = path == 3 ? warps : 1;
  const int n_qb = (Q + width - 1) / width;
  out[0] = path;
  out[1] = spl;
  out[2] = width;
  out[3] = n_chunks;
  out[4] = n_qb;
  out[5] = (n_chunks + per_block - 1) / per_block * n_qb;
  out[6] = (Q * (2 * M + 1) + 31) / 32;
  out[7] = static_cast<int>(fms_block_smem(path, spl, warps, L, C, V, M));
  out[8] = n_sm;
  out[9] = FMS_ROWS;
  out[10] = path == 0 ? any_vw(C, V) : 0;
  out[11] = static_cast<int>(fms_word_count(path, Q, C, V));
  out[12] = per_block;
  return 0;
}

// Plain C entry point of K4 (bound with ctypes). Launches both passes on
// `stream`, allocates nothing, and returns cudaGetLastError().
// mask: (T, Q) f64; meas: the group's first of M <= 8 measures, rows
// `meas_stride` apart; scratch: (ceil(T/chunk), Q, 2M+1) f64; out: (Q,
// 2 m_out + 1) f64, of which the group writes its own columns (as K1's).
// The grid is ceil(T/chunk) * ceil(Q/128) blocks of four warps, q tiles
// fastest (mpa_plan reports it; the wrapper's plan mirrors it).
extern "C" int mpa_launch(const double* mask, const double* meas,
                          int meas_stride, int T, int Q, int M, int col0,
                          int m_out, int chunk, double* scratch, double* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (M > MAX_M || M < 0 || chunk <= 0 || col0 < 0 || col0 + M > m_out)
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
             s>>>(mask, meas, meas_stride, T, Q, chunk, n_qb, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return launch_fold(scratch, n_chunks, Q, M, col0, m_out, out, s);
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
