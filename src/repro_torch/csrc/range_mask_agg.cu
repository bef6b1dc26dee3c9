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
// The fold order: the tuples are cut into chunks of `chunk` (256). For each
// snippet and column the tuples of a chunk are folded in ascending order
// from 0.0 with w = (every compare holds) ? extra[t, q] : 0 as
// acc = fmaf(w, payload[t, p], acc); a second pass sums the chunks in
// ascending order from 0.0. The result is the same bits on every run (no
// float atomics), a snippet's row does not depend on Q, and a column's bits
// do not depend on the columns that ride along.
//
// What bounds it on the H100: bytes. It reads the f32 extra mask once,
// T*Q*4 bytes (30.7 MB, ~9 us at 3.35 TB/s for T = 60,013 and Q = 128),
// and does ~2(L + P) operations per (tuple, snippet) pair (~2 us at P = 5;
// at P = 35 the FMA issue, ~9 us, matches the bytes).
//
// Design (redesigned for Hopper, on K4's: csrc/fused_masked_scan.cu):
//  * A warp owns (one chunk) x (a tile of 32 snippets) x (a group of at
//    most RMA_GROUP payload columns), one lane a snippet. A block holds up
//    to RMA_TILES neighbouring snippet tiles of one chunk and, for each,
//    the warps of up to RMA_BLOCK_GROUPS column groups; the tiles vary
//    fastest over the grid. The groups are as few as RMA_GROUP allows, of
//    equal width but the last (which folds zero columns beside its own:
//    that changes no live column's bits), so a wide payload gets more
//    warps, not a longer chain.
//  * Each tile streams its (chunk x 32) slab of `extra` through a ring of
//    RMA_STAGES stages of RMA_ROWS rows in shared memory, filled with
//    cp.async by the tile's first warp (16 bytes a lane when Q is a
//    multiple of 4 and the mask is 16-byte aligned, else 4), one
//    commit/wait group a stage; the tile's group warps read it together
//    (a named barrier a stage), so the mask is read once for every group.
//  * The chunk's x and the block's payload columns reach shared memory once
//    a block, by cp.async in the ring's first group (one block barrier after
//    it lands), read by a whole warp at once (broadcasts).
//  * The widened bounds are formed once: in registers for L <= RMA_LB
//    (padded dims compare x = 0 against [-inf, inf]), else in shared memory
//    as a lane's column, [tile][dim][lane].
//  * The group's width is a template argument (1 .. RMA_GROUP), so the
//    per-tuple update is straight-line. A warp forms a stage's 32 weights
//    first (independent chains the scheduler interleaves), then folds them
//    in tuple order.
//  * The ordered sum over chunks is a second launch (rma_fold), K4's second
//    pass in float32: a block copies 32 outputs' partials of up to 256
//    chunks into shared memory at once, then one lane an output sums them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "async_copy.cuh"

namespace {

constexpr int RMA_TILES = 4;    // snippet tiles a block
constexpr int RMA_BLOCK_GROUPS = 4;  // column groups a block (warps a tile)
constexpr int RMA_ROWS = 32;    // mask rows a ring stage (4 KB a tile)
constexpr int RMA_STAGES = 2;   // ring depth: one stage in flight
constexpr int RMA_LB = 4;       // numeric dims whose bounds sit in registers
constexpr bool RMA_REG_BOUNDS = true;  // ... or every dim's in shared memory
static_assert(RMA_LB == 4, "a tuple's x in registers is one float4");
constexpr int RMA_GROUP = 20;   // payload columns a warp folds
constexpr int FOLD_CHUNKS = 256;  // chunks rma_fold stages at once
constexpr int FOLD_THREADS = 256;
constexpr size_t FOLD_SMEM = sizeof(float) * FOLD_CHUNKS * 32;
constexpr size_t SMEM_OPT_IN = 227 * 1024;

// Columns of each group of P columns: as few groups of at most RMA_GROUP
// as P allows, of equal width but the last.
int rma_group_width(int P) {
  const int n_groups = (P + RMA_GROUP - 1) / RMA_GROUP;
  return (P + n_groups - 1) / n_groups;
}

__host__ __device__ inline bool rma_reg_bounds(int L) {
  return RMA_REG_BOUNDS && L <= RMA_LB;
}

// A payload row of one group in shared memory (float4s).
__host__ __device__ constexpr int rma_ps(int PW) { return (PW + 3) / 4 * 4; }

// Shared memory of a block of `tiles` tiles and `gbn` groups, in floats:
// the rings, the bounds past the registers, x and the groups' payload.
__host__ __device__ inline size_t rma_smem_floats(int tiles, int gbn,
                                                  int chunk, int L, int PW) {
  const int lx = rma_reg_bounds(L) ? RMA_LB : L;
  return (size_t)tiles * RMA_STAGES * RMA_ROWS * 32 +
         (rma_reg_bounds(L) ? 0 : (size_t)tiles * 2 * L * 32) +
         (size_t)chunk * (lx + gbn * rma_ps(PW));
}

// a & b, opaque to the compiler, so that it does not feed one compare's
// predicate into the next (a serial chain of FSETPs a tuple).
__device__ __forceinline__ uint32_t and_opaque(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("and.b32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Wait until the `n` warps of one tile reach barrier `id` (a warp alone:
// __syncwarp).
__device__ __forceinline__ void tile_sync(int id, int n) {
  if (n == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * n) : "memory");
}

template <int PW>
__global__ void __launch_bounds__(32 * RMA_TILES * RMA_BLOCK_GROUPS)
    rma_partials(const float* __restrict__ x,
                 const float* __restrict__ payload, int pstride,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 const float* __restrict__ extra, int T, int Q, int L, int P,
                 int gbn, int n_gb, int chunk, int n_qb, float eps,
                 int vec16, float* __restrict__ scratch) {
  constexpr int R = RMA_ROWS;
  constexpr int S = RMA_STAGES;
  constexpr int PS = rma_ps(PW);
  extern __shared__ __align__(16) float rma_smem[];
  const int n_tiles = blockDim.x / 32 / gbn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = warp / gbn, gl = warp % gbn;  // gl: the block's group
  const bool loader = gl == 0;  // the warp that fills the tile's ring
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int qb = blockIdx.x % n_qb;
  const int gb = blockIdx.x / n_qb % n_gb;
  const int c = blockIdx.x / n_qb / n_gb;
  const int first = (gb * gbn + gl) * PW;  // this warp's first column
  const int cols = max(0, min(PW, P - first));
  const int q0 = (qb * n_tiles + tile) * 32;
  const int q = q0 + lane;
  const int width = max(0, min(32, Q - q0));  // live snippets of the tile
  const bool reg_bounds = rma_reg_bounds(L);
  const int lx = reg_bounds ? RMA_LB : L;
  float* ring = rma_smem + tile * S * R * 32;             // [S][R][32]
  float* bnd = rma_smem + n_tiles * S * R * 32;           // [tile][2L][32]
  float* x_s = bnd + (reg_bounds ? 0 : n_tiles * 2 * L * 32);  // [chunk][lx]
  float* p_s = x_s + chunk * lx;                          // [chunk][gbn][PS]
  float* lo_s = bnd + tile * 2 * L * 32;
  float* hi_s = lo_s + L * 32;

  const int t_begin = c * chunk;
  const int n_rows = min(chunk, T - t_begin);
  const int n_st = (n_rows + R - 1) / R;
  const float* slab = extra + (size_t)t_begin * Q + q0;

  auto load_stage = [&](int st) {
    float* dst = ring + (st % S) * R * 32;
    const int r0 = st * R;
    const int nr = min(R, n_rows - r0);
    if (vec16) {  // 8 column quads a row, four rows a pass
      const int quad = lane & 7;
      if (4 * quad < width)
        for (int r = lane >> 3; r < nr; r += 4)
          cp_async<16>(dst + r * 32 + 4 * quad,
                       slab + (size_t)(r0 + r) * Q + 4 * quad);
    } else if (lane < width) {
      for (int r = 0; r < nr; ++r)
        cp_async<4>(dst + r * 32 + lane, slab + (size_t)(r0 + r) * Q + lane);
    }
  };

  // The chunk's x (padded dims zero) and the block's payload columns (zero
  // past each group's own), in the ring's group 0.
  for (int i = tid; i < n_rows * lx; i += n_threads) {
    const int r = i / lx, k = i % lx;
    if (k < L)
      cp_async<4>(x_s + i, x + (size_t)(t_begin + r) * L + k);
    else
      x_s[i] = 0.0f;
  }
  for (int i = tid; i < n_st * R * gbn * PS; i += n_threads) {
    const int r = i / (gbn * PS), rest = i % (gbn * PS);
    const int j = rest % PS, col = (gb * gbn + rest / PS) * PW + j;
    if (r < n_rows && j < PW && col < P)
      cp_async<4>(p_s + i, payload + (size_t)(t_begin + r) * pstride + col);
    else
      p_s[i] = 0.0f;  // past the group's columns or the chunk's rows
  }
  // The widened bounds, formed once.
  const float inf = __int_as_float(0x7f800000);
  float lo_r[RMA_LB], hi_r[RMA_LB];
#pragma unroll
  for (int k = 0; k < RMA_LB; ++k) {
    const bool use = reg_bounds && k < L && q < Q;
    lo_r[k] = use ? __fsub_rn(lo[(size_t)q * L + k], eps) : -inf;
    hi_r[k] = use ? __fadd_rn(hi[(size_t)q * L + k], eps) : inf;
  }
  if (!reg_bounds && loader)
    for (int k = 0; k < L; ++k) {
      lo_s[k * 32 + lane] = q < Q ? __fsub_rn(lo[(size_t)q * L + k], eps) : 0;
      hi_s[k * 32 + lane] = q < Q ? __fadd_rn(hi[(size_t)q * L + k], eps) : 0;
    }
  for (int st = 0; st < S - 1; ++st) {
    if (loader && st < n_st) load_stage(st);
    cp_async_commit();
  }
  float acc[PW];
#pragma unroll
  for (int j = 0; j < PW; ++j) acc[j] = 0.0f;

  for (int st = 0; st < n_st; ++st) {  // n_st is the same for every warp
    cp_async_wait<S - 2>();  // stage st has landed (this lane's copies)
    if (st == 0)
      __syncthreads();  // ... and every thread's x, payload and bounds
    else
      tile_sync(1 + tile, gbn);  // ... the tile's, and stage st-1 is read
    if (loader && st + S - 1 < n_st) load_stage(st + S - 1);
    cp_async_commit();
    const float* e_col = ring + (st % S) * R * 32 + lane;
    const int r0 = st * R;
    const int nr = min(R, n_rows - r0);
    // The stage's weights first, each tuple's apart (independent chains),
    // then the fold in tuple order. A row past the chunk weighs 0 against a
    // zero payload: fmaf(0, 0, acc) is acc (acc is never -0).
    float wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = r0 + r;
      bool hit = true;
      if (reg_bounds) {
        const float4 xv = *reinterpret_cast<const float4*>(x_s + t * 4);
        hit = and_opaque((xv.x >= lo_r[0]) & (xv.x <= hi_r[0]) &
                             (xv.y >= lo_r[1]) & (xv.y <= hi_r[1]),
                         (xv.z >= lo_r[2]) & (xv.z <= hi_r[2]) &
                             (xv.w >= lo_r[3]) & (xv.w <= hi_r[3]));
      } else {
        for (int k = 0; k < L; ++k) {
          const float xv = x_s[t * L + k];
          hit = hit & (xv >= lo_s[k * 32 + lane]) &
                (xv <= hi_s[k * 32 + lane]);
        }
      }
      wv[r] = (r < nr && hit) ? e_col[r * 32] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* pr = reinterpret_cast<const float4*>(
          p_s + ((r0 + r) * gbn + gl) * PS);
#pragma unroll
      for (int j4 = 0; j4 < PS / 4; ++j4) {
        const float4 pv = pr[j4];
        const float v[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * j4 + u < PW)
            acc[4 * j4 + u] = __fmaf_rn(wv[r], v[u], acc[4 * j4 + u]);
      }
    }
  }
  cp_async_wait<0>();
  if (q < Q) {  // column-major, so a warp's stores are one line a column
    float* dst = scratch + ((size_t)c * P + first) * Q + q;
#pragma unroll
    for (int j = 0; j < PW; ++j)
      if (j < cols) dst[(size_t)j * Q] = acc[j];
  }
}

// The second pass: for each of the Q x P outputs, the sum over chunks
// c = 0, 1, ... of scratch[c, p, q], in that order from 0.0, written to
// out[q, p] (rows `os` apart). A block owns 32 outputs: all eight warps copy
// the chunks' values into shared memory with cp.async (every load in flight
// at once), then warp 0 sums them, one lane an output, in chunk order.
__global__ void __launch_bounds__(FOLD_THREADS)
    rma_fold(const float* __restrict__ scratch, int n_chunks, int Q, int P,
             int os, float* __restrict__ out) {
  extern __shared__ __align__(16) float fold_smem[];  // [FOLD_CHUNKS][32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = Q * P;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  for (int c0 = 0; c0 < n_chunks; c0 += FOLD_CHUNKS) {
    const int nc = min(FOLD_CHUNKS, n_chunks - c0);
    if (i < n)
      for (int k = warp; k < nc; k += FOLD_THREADS / 32)
        cp_async<4>(fold_smem + k * 32 + lane,
                    scratch + (size_t)(c0 + k) * n + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0)
      for (int k = 0; k < nc; ++k) s = __fadd_rn(s, fold_smem[k * 32 + lane]);
    __syncthreads();
  }
  if (warp == 0 && i < n) out[(size_t)(i % Q) * os + i / Q] = s;
}

using RmaKernel = void (*)(const float*, const float*, int, const float*,
                           const float*, const float*, int, int, int, int,
                           int, int, int, int, float, int, float*);

template <int... W>
RmaKernel rma_kernel(int w, std::integer_sequence<int, W...>) {
  RmaKernel k = nullptr;
  ((w == W + 1 ? (k = rma_partials<W + 1>, 0) : 0), ...);
  return k;
}

// The kernel of a group width (1 .. RMA_GROUP).
RmaKernel rma_kernel(int w) {
  return rma_kernel(w, std::make_integer_sequence<int, RMA_GROUP>{});
}

// K5's launch for a shape: columns a group, groups, groups a block, group
// blocks, snippet tiles a block (the most of RMA_TILES, 2, 1 whose staging
// fits a block's shared memory; 0 when none does), q blocks.
struct RmaPlan {
  int pw, groups, gbn, n_gb, tiles, n_qb;
};

RmaPlan rma_plan_of(int Q, int L, int P, int chunk) {
  RmaPlan p{};
  if (P <= 0) return p;
  p.pw = rma_group_width(P);
  p.groups = (P + p.pw - 1) / p.pw;
  p.gbn = min(p.groups, RMA_BLOCK_GROUPS);
  p.n_gb = (p.groups + p.gbn - 1) / p.gbn;
  for (int t = RMA_TILES; t >= 1 && !p.tiles; t /= 2)
    if (rma_smem_floats(t, p.gbn, chunk, L, p.pw) * sizeof(float) <=
        SMEM_OPT_IN)
      p.tiles = t;
  p.n_qb = p.tiles ? (Q + 32 * p.tiles - 1) / (32 * p.tiles) : 0;
  return p;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches both passes on `stream`,
// allocates nothing, and returns cudaGetLastError().
// x: (T, L); payload: the first of P columns, rows `payload_stride` apart;
// lo/hi: (Q, L); extra: (T, Q), all f32; scratch: ceil(T/chunk) * Q * P f32;
// out: the first column of the output, rows `out_stride` apart. One launch
// folds every column.
extern "C" int rma_launch(const float* x, const float* payload,
                          int payload_stride, const float* lo,
                          const float* hi, const float* extra, int T, int Q,
                          int L, int P, int chunk, float eps, float* scratch,
                          float* out, int out_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0) return 0;
  if (P <= 0 || chunk <= 0 || chunk % RMA_ROWS || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  if (n_chunks > 0) {
    const RmaPlan p = rma_plan_of(Q, L, P, chunk);
    if (!p.tiles) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (long long)n_chunks * p.n_gb * p.n_qb;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const RmaKernel kernel = rma_kernel(p.pw);
    static uint64_t opted_in[RMA_GROUP + 1] = {};
    cudaError_t e =
        opt_in_smem(reinterpret_cast<const void*>(kernel), opted_in[p.pw]);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int vec16 = Q % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(extra) % 16 == 0;
    kernel<<<static_cast<unsigned>(blocks), 32 * p.tiles * p.gbn,
             rma_smem_floats(p.tiles, p.gbn, chunk, L, p.pw) *
                 sizeof(float),
             s>>>(x, payload, payload_stride, lo, hi, extra, T, Q, L, P,
                  p.gbn, p.n_gb, chunk, p.n_qb, eps, vec16, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static uint64_t fold_opted_in = 0;
  cudaError_t e = opt_in_smem(reinterpret_cast<const void*>(rma_fold),
                              fold_opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = Q * P;
  rma_fold<<<(n + 31) / 32, FOLD_THREADS, FOLD_SMEM, s>>>(
      scratch, n_chunks, Q, P, out_stride, out);
  return static_cast<int>(cudaGetLastError());
}

// K5's launch plan as the launch above computes it, for the wrapper's
// tests: out = {columns a group, groups, groups a block, snippet tiles a
// block, partial blocks, dynamic shared memory a block (bytes), fold
// blocks}. Returns 0.
extern "C" int rma_plan(int T, int Q, int L, int P, int chunk, int* out) {
  const RmaPlan p = rma_plan_of(Q, L, P, chunk);
  const int n_chunks = T > 0 ? (T + chunk - 1) / chunk : 0;
  out[0] = p.pw;
  out[1] = p.groups;
  out[2] = p.gbn;
  out[3] = p.tiles;
  out[4] = n_chunks * p.n_gb * p.n_qb;
  out[5] = p.tiles ? static_cast<int>(rma_smem_floats(p.tiles, p.gbn, chunk,
                                                      L, p.pw) *
                                      sizeof(float))
                   : 0;
  out[6] = (Q * P + 31) / 32;
  return 0;
}
