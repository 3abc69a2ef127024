// K4: batched exact minimum-weight vertex cover of small instances, by
// meet-in-the-middle over the complements (independent sets).
//
// Replaces the JAX package's one Pallas kernel,
// gnn_mwvc_tpu/ops/smallsolve_pallas.py::pallas_small_mwvc (its _kernel body
// and the _mitm_tables precompute).  The result is bit for bit the same: per
// instance the minimum cover cost, and among the covers of that cost the
// smallest cover bitmask over all n bits, then AND-ed with the bitmask of
// used (non-padding) vertices.  A self-loop bit forces a vertex into the
// cover.
//
// A subset s is a cover iff its complement c is an independent set, and
// cost(s) = total_w - w(c).  c is split into 7 low bits (128 patterns) and
// n - 7 high bits; c is independent iff its low part is, its high part is,
// and no low vertex is adjacent to a chosen high vertex:
//   (cross_low[c_low] & c_high) == 0.
//
// Bound on the H100: integer ALU work, 2^n subset tests per instance
// (B = 1024, n = 20: ~1.07e9 tests per batch); no device-memory traffic
// beyond reading 2n ints and writing 2 per instance.
//
// Design: one block per instance.  Thread t owns low pattern c_low = t % 128
// and keeps its base cost, low independence and cross mask in registers;
// the block's 256 threads form 2 groups that split the high patterns.  The
// high table (w(c_high), or -1 where c_high is not independent: 2^13 ints,
// 32 KB at n = 20, so below the 48 KB static limit) is built once in shared
// memory and read as a broadcast.  Each thread keeps the lexicographic
// minimum of (cost, s) packed into one 64-bit key, cost << 32 | s; a block
// reduction of the keys with min gives the result.  min is exact and order
// free, so the result does not depend on the schedule.  The TPU's (8, 128)
// instance x lane blocks and its sequential grid walk are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNLow = 7;
constexpr int kLow = 1 << kNLow;     // 128 low patterns
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLow;
constexpr int kMaxN = 20;

__global__ void __launch_bounds__(kThreads)
small_mwvc_mitm_kernel(const int* __restrict__ adj,
                       const int* __restrict__ w,
                       int* __restrict__ best_cost,
                       int* __restrict__ best_set, int n) {
  extern __shared__ int high_tab[];  // (1 << (n - 7)) entries
  __shared__ int s_adj[kMaxN];
  __shared__ int s_w[kMaxN];
  __shared__ unsigned long long s_red[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < n) {
    s_adj[tid] = adj[(int64_t)b * n + tid];
    s_w[tid] = w[(int64_t)b * n + tid];
  }
  __syncthreads();

  const int n_high = n - kNLow;
  const int nh = 1 << n_high;
  const int high_mask = nh - 1;

  // high table: w(c_high), or -1 if c_high is not independent
  for (int ch = tid; ch < nh; ch += kThreads) {
    int wh = 0;
    bool viol = false;
    for (int j = 0; j < n_high; ++j) {
      if ((ch >> j) & 1) {
        const int aj = s_adj[kNLow + j];
        wh += s_w[kNLow + j];
        viol |= (((aj >> kNLow) & high_mask & ch) != 0);
      }
    }
    high_tab[ch] = viol ? -1 : wh;
  }

  int total_w = 0;
  int used_mask = 0;
  for (int j = 0; j < n; ++j) {
    total_w += s_w[j];
    if (s_w[j] != 0 || s_adj[j] != 0) used_mask |= 1 << j;
  }

  // this thread's low pattern, in registers
  const int cl = tid % kLow;
  int w_low = 0, cross = 0;
  bool viol_low = false;
  for (int j = 0; j < kNLow; ++j) {
    if ((cl >> j) & 1) {
      const int aj = s_adj[j];
      w_low += s_w[j];
      viol_low |= ((aj & (kLow - 1) & cl) != 0);
      cross |= (aj >> kNLow) & high_mask;
    }
  }
  const int base = total_w - w_low;
  const unsigned s_base = (unsigned)(((1 << n) - 1) ^ cl);
  __syncthreads();

  unsigned long long best = ~0ULL;
  if (!viol_low) {
    for (int ch = tid / kLow; ch < nh; ch += kGroups) {
      const int wh = high_tab[ch];
      if (wh >= 0 && (cross & ch) == 0) {
        const unsigned cost = (unsigned)(base - wh);
        const unsigned s = s_base ^ ((unsigned)ch << kNLow);
        const unsigned long long key =
            ((unsigned long long)cost << 32) | (unsigned long long)s;
        best = key < best ? key : best;
      }
    }
  }

  // block min-reduction of the packed (cost, s) keys
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = tid < kThreads / 32 ? s_red[tid] : ~0ULL;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    if (tid == 0) {
      best_cost[b] = (int)(best >> 32);
      best_set[b] = (int)(best & 0xffffffffULL) & used_mask;
    }
  }
}

}  // namespace

extern "C" int small_mwvc_mitm_i32(const int* adj, const int* w,
                                   int* best_cost, int* best_set, int batch,
                                   int n, cudaStream_t stream) {
  if (n < kNLow + 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(int) << (n - kNLow);
  small_mwvc_mitm_kernel<<<batch, kThreads, smem, stream>>>(
      adj, w, best_cost, best_set, n);
  return (int)cudaGetLastError();
}
