// Group discovery for Hopper (sm_90a): which group-by values occur among
// the tuples of the first sample batch that each probe admits.
//
// Replaces no TPU kernel. The reference (src/repro/core/engine.py,
// VerdictEngine._discover_groups_many) evaluates every group-by query's
// COUNT probe with the jnp predicate mask over the first sample batch,
// padded to 128 snippets, copies the whole (tuples x 128) mask and the
// batch's codes to the host and takes np.unique there. On the card that
// copy was a 614 MB float64 mask a flush at TPC-H SF10, for a result of a
// few group tuples. This kernel reduces on the card, and only the marks
// cross to the host.
//
// For each probe p and tuple t:
//
//     admit[t, p] = AND_k (lo[p,k] <= x[t,k] <= hi[p,k])
//                   AND_k member[p, k, codes[t,k]]
//     code[t, p]  = sum_j codes[t, gcol[p,j]] * gstride[p,j]
//
// lo and hi arrive widened (lo - RANGE_EPS, hi + RANGE_EPS, formed once in
// float64 by the wrapper), so the kernel and the plain version compare the
// same doubles as the scan's snippet mask. code is the mixed-radix code of
// the probe's group-by columns in their order, with the radices the
// schema's category sizes: ascending codes are the lexicographic order of
// the group tuples.
//
// Two routes, decided per probe by the wrapper from its key space (the
// product of its group-by sizes):
//  * table (while the launch's tables fit GD_TABLE_KEYS bytes together, a
//    bound of ops.py): presence[off + code] = 1 for every admitted tuple.
//    A block keeps the tables in shared memory, one byte a key, and tests
//    a byte before it sets it, so hot keys (returnflag's three) do not
//    serialise: no atomics at all, and racing writers store the same 1.
//    Each block merges its table into the global one once, at its end,
//    writing only the keys it set.
//  * sorted (a probe whose table does not fit): keys[row, t] = admitted ?
//    code : KEY_NONE, every tuple written, so the wrapper's sort-unique
//    finds the distinct codes on the card.
//
// What bounds it on the H100: bytes at one probe, instructions past it. One
// pass over the batch reads T(8L + 4C) bytes (21.6 MB at SF10's 599,861
// tuples, L = C = 3: ~6.4 us at 3.35 TB/s); the probes' bounds, sets and
// tables are a few KB, read from L1 (the bounds at one address a warp:
// broadcasts). Each (tuple, probe) pair costs about 2L + C + 2G loads and
// compares in loops of run-time length and a 64-bit multiply-add a group
// column, so each probe adds ~7 us at that shape (H100 80GB HBM3, 700 W:
// 9.5 us at one probe, 117 us at 16).
//
// Design: a block of GD_THREADS threads owns one chunk of GD_CHUNK tuples
// (a thread a tuple, strided by the block, so neighbouring threads read
// neighbouring tuples and write neighbouring sorted keys; 512 fills the
// card at SF10, where 2048 left it two blocks an SM) and every probe of the
// launch. The wrapper lays the tables out back to back; together they fit
// GD_TABLE_KEYS bytes of shared memory (a probe whose table would not fit
// takes the sorted route). Codes outside [0, sizes) are the caller's fault
// (the engine checks its sample once): the kernel then reads and writes
// nothing outside its arguments, but marks what the plain version would
// not.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GD_THREADS = 256;
constexpr int GD_CHUNK = 512;  // tuples a block: 2 a thread
constexpr long long KEY_NONE = 0x7fffffffffffffffLL;  // a tuple not admitted

// route: (P, 2) rows of (offset of the probe's table in presence, its key
// space) on the table route, or (-1, its row of keys) on the sorted route.
// n_keys: the presence table's length (the shared memory a block holds).
__global__ void __launch_bounds__(GD_THREADS)
    gd_mark(const double* __restrict__ x, const int* __restrict__ codes,
            int T, int L, int C, int V, int P, const double* __restrict__ lo,
            const double* __restrict__ hi,
            const unsigned char* __restrict__ member, int G,
            const long long* __restrict__ gcol,
            const long long* __restrict__ gstride,
            const long long* __restrict__ route, int n_keys,
            unsigned char* __restrict__ presence,
            long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char gd_table[];
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x) gd_table[i] = 0;
  __syncthreads();

  const int t1 = min(T, (blockIdx.x + 1) * GD_CHUNK);
  for (int t = blockIdx.x * GD_CHUNK + threadIdx.x; t < t1;
       t += blockDim.x) {
    const double* xt = x + static_cast<size_t>(t) * L;
    const int* ct = codes + static_cast<size_t>(t) * C;
    for (int p = 0; p < P; ++p) {
      bool in = true;
      const double* lp = lo + static_cast<size_t>(p) * L;
      const double* hp = hi + static_cast<size_t>(p) * L;
      for (int k = 0; k < L; ++k) {
        const double v = __ldg(xt + k);
        in = in & (v >= __ldg(lp + k)) & (v <= __ldg(hp + k));
      }
      const unsigned char* mp = member + static_cast<size_t>(p) * C * V;
      for (int k = 0; k < C; ++k) {
        const int c = __ldg(ct + k);
        in = in && static_cast<unsigned>(c) < static_cast<unsigned>(V) &&
             __ldg(mp + static_cast<size_t>(k) * V + c) != 0;
      }
      const long long off = __ldg(route + 2 * p);
      if (off >= 0 && !in) continue;
      long long code = 0;
      for (int j = 0; j < G; ++j) {
        const int col = static_cast<int>(__ldg(gcol + p * G + j));
        code += static_cast<long long>(__ldg(ct + col)) *
                __ldg(gstride + p * G + j);
      }
      const long long arg = __ldg(route + 2 * p + 1);
      if (off >= 0) {
        if (code >= 0 && code < arg) {
          unsigned char* e = gd_table + off + code;
          if (*e == 0) *e = 1;
        }
      } else {
        keys[static_cast<size_t>(arg) * T + t] = in ? code : KEY_NONE;
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x)
    if (gd_table[i]) presence[i] = 1;
}

}  // namespace

// One launch over every probe of a flush. presence (n_keys bytes, at most
// GD_TABLE_KEYS: under the 48 KB a block gets without opting in) must hold
// zeros; keys needs no initial value (every (row, t) is written). Returns
// cudaGetLastError() of the launch.
extern "C" int gd_launch(const double* x, const int* codes, int T, int L,
                         int C, int V, int P, const double* lo,
                         const double* hi, const unsigned char* member, int G,
                         const long long* gcol, const long long* gstride,
                         const long long* route, int n_keys,
                         unsigned char* presence, long long* keys,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || P <= 0) return 0;
  if (L < 0 || C < 0 || V <= 0 || G <= 0 || n_keys < 0 ||
      n_keys > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (T + GD_CHUNK - 1) / GD_CHUNK;
  gd_mark<<<grid, GD_THREADS, n_keys, s>>>(x, codes, T, L, C, V, P, lo, hi,
                                           member, G, gcol, gstride, route,
                                           n_keys, presence, keys);
  return static_cast<int>(cudaGetLastError());
}
