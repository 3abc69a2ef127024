// K4: batched exact minimum-weight vertex cover of small instances, by
// meet-in-the-middle over the complements (independent sets).
//
// Replaces the JAX package's one Pallas kernel,
// gnn_mwvc_tpu/ops/smallsolve_pallas.py::pallas_small_mwvc (its _kernel body
// and the _mitm_tables precompute).  The result is bit for bit the same: per
// instance the minimum cover cost, and among the covers of that cost the
// smallest cover bitmask over all n bits, then AND-ed with the bitmask of
// used (non-padding) vertices.  A self-loop bit forces a vertex into the
// cover.  Weights are nonnegative with a per-instance total below 2^30.
//
// A subset s is a cover iff its complement c is an independent set, and
// cost(s) = total_w - w(c).  The Pallas kernel (and the plain version in
// ops/smallsolve_mitm.py) splits c into 7 low and n - 7 high bits and tests
// every (low, high) pair: 2^n pairs per instance at about 3 integer
// operations each (the feasibility AND, the subtraction, the running
// minimum).  On the H100 that is bounded at 1024 * 2^20 * 3 / 16.7e12
// int32 op/s = 0.19 ms for the assist's batch (B = 1024, n = 20); the first
// CUDA version of this kernel took 0.60 ms.
//
// This kernel avoids the pair enumeration.  Split c into L = n/2 low and
// H = n - L high bits.  For a fixed independent low part c_l with high
// neighbourhood X(c_l), the best completion is the maximum of the key
// (w(c_h), c_h) over the independent c_h inside the complement of X(c_l):
// the cost falls as w(c_h) rises, and at equal weight the cover bitmask
// s = full ^ c_l ^ (c_h << L) falls strictly as c_h rises, so the
// lexicographic maximum of (w(c_h), c_h) is the lexicographic minimum of
// (cost, s).  One subset-maximum transform (sum over subsets with max, H
// rounds over 2^(H-1) pairs) gives that maximum for every mask at once:
//   F[m] = max over c_h subset of m, c_h independent, of w(c_h) << 32 | c_h
// (0 for a dependent c_h, which loses to every independent one but the
// empty set, whose key is 0 too).  Each low pattern then reads
// F[~X(c_l)] once.  Work per instance: 2^H table entries, H * 2^(H-1)
// maxima, 2^L lookups: about 11k steps at n = 20 instead of 2^20 pairs.
// What bounds it now is the dependency chain inside a block (the transform's
// H rounds, each behind a barrier) and the launch, not arithmetic.
//
// The reference reads the adjacency through its 7-bit split: a low vertex's
// bits for high vertices give the low-high conflicts, a high vertex's bits
// for low vertices are never read.  The kernel first builds the conflict
// masks exactly as that split reads them and makes them symmetric, so any
// split (here n/2) gives the same answer on any input, symmetric or not.
//
// Design: one block of 256 threads per instance; the table F (2^H 64-bit
// keys, 8 KB at n = 20) lives in shared memory, so 8 blocks fit on an SM and
// the assist's batch of 1024 runs in one wave on 132 SMs.  Thread t owns
// the patterns t + 256 k: it sums the weights and ORs the neighbour masks of
// the pattern's first 8 bits once, then adds the remaining bits per k.  The
// (cost, s) result is packed as cost << 32 | s and min-reduced over the
// block; min is exact and order free, so the schedule does not matter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThreadBits = 8;  // log2(kThreads)
constexpr int kRefLow = 7;      // the reference's split point

template <int N>
__global__ void __launch_bounds__(kThreads)
small_mwvc_mitm_kernel(const int* __restrict__ adj,
                       const int* __restrict__ w,
                       int* __restrict__ best_cost,
                       int* __restrict__ best_set) {
  constexpr int L = N / 2;
  constexpr int H = N - L;
  constexpr int NL = 1 << L;
  constexpr int NH = 1 << H;
  constexpr unsigned kFull = (1u << N) - 1;
  static_assert(L >= kThreadBits && H >= kThreadBits, "n must be 16..20");

  __shared__ unsigned long long f[NH];
  __shared__ unsigned s_read[N];  // adjacency bits the reference reads
  __shared__ unsigned s_nb[N];    // symmetric conflict masks
  __shared__ int s_w[N];
  __shared__ unsigned long long s_red[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned used = 0;  // used-vertex mask, kept by warp 0
  if (tid < 32) {
    unsigned raw = 0;
    int wt = 0;
    if (tid < N) {
      raw = (unsigned)adj[(int64_t)b * N + tid];
      wt = w[(int64_t)b * N + tid];
      // a high vertex's bits for low vertices are never read
      const unsigned side =
          tid < kRefLow ? kFull : kFull & ~((1u << kRefLow) - 1);
      s_read[tid] = raw & side;
      s_w[tid] = wt;
    }
    used = __ballot_sync(0xffffffffu, tid < N && (wt != 0 || raw != 0));
  }
  __syncthreads();
  if (tid < N) {
    unsigned nb = s_read[tid];
#pragma unroll
    for (int v = 0; v < N; ++v) nb |= ((s_read[v] >> tid) & 1u) << v;
    s_nb[tid] = nb;
  }
  __syncthreads();

  int tot = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) tot += s_w[j];

  // high table: key of c_h = t + 256 k, or 0 when c_h is not independent
  {
    int w0 = 0;
    unsigned nb0 = 0;
#pragma unroll
    for (int j = 0; j < kThreadBits; ++j) {
      if ((tid >> j) & 1) {
        w0 += s_w[L + j];
        nb0 |= s_nb[L + j] >> L;
      }
    }
#pragma unroll
    for (int k = 0; k < NH / kThreads; ++k) {
      const unsigned ch = (unsigned)(tid + k * kThreads);
      int wh = w0;
      unsigned nb = nb0;
#pragma unroll
      for (int j = kThreadBits; j < H; ++j) {
        if ((ch >> j) & 1) {
          wh += s_w[L + j];
          nb |= s_nb[L + j] >> L;
        }
      }
      f[ch] = (nb & ch) ? 0ULL
                        : ((unsigned long long)(unsigned)wh << 32 | ch);
    }
  }

  // subset-maximum transform over the H high bits
#pragma unroll
  for (int bit = 0; bit < H; ++bit) {
    __syncthreads();
    for (int i = tid; i < NH / 2; i += kThreads) {
      const unsigned lo = (unsigned)i & ((1u << bit) - 1);
      const unsigned m = (((unsigned)i >> bit) << (bit + 1)) | (1u << bit) | lo;
      const unsigned long long a = f[m];
      const unsigned long long c = f[m ^ (1u << bit)];
      if (c > a) f[m] = c;
    }
  }
  __syncthreads();

  // low patterns: one lookup each
  unsigned long long best = ~0ULL;
  {
    int w0 = 0;
    unsigned nb0 = 0;
#pragma unroll
    for (int j = 0; j < kThreadBits; ++j) {
      if ((tid >> j) & 1) {
        w0 += s_w[j];
        nb0 |= s_nb[j];
      }
    }
#pragma unroll
    for (int k = 0; k < NL / kThreads; ++k) {
      const unsigned cl = (unsigned)(tid + k * kThreads);
      int wl = w0;
      unsigned nb = nb0;
#pragma unroll
      for (int j = kThreadBits; j < L; ++j) {
        if ((cl >> j) & 1) {
          wl += s_w[j];
          nb |= s_nb[j];
        }
      }
      if ((nb & cl) == 0) {
        const unsigned long long key = f[~(nb >> L) & (NH - 1)];
        const unsigned wh = (unsigned)(key >> 32);
        const unsigned ch = (unsigned)key;
        const unsigned cost = (unsigned)(tot - wl) - wh;
        const unsigned s = kFull ^ cl ^ (ch << L);
        const unsigned long long cand = (unsigned long long)cost << 32 | s;
        best = cand < best ? cand : best;
      }
    }
  }

  // block min-reduction of the packed (cost, s) keys
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = tid < kThreads / 32 ? s_red[tid] : ~0ULL;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    if (tid == 0) {
      best_cost[b] = (int)(best >> 32);
      best_set[b] = (int)((unsigned)best & used);
    }
  }
}

}  // namespace

extern "C" int small_mwvc_mitm_i32(const int* adj, const int* w,
                                   int* best_cost, int* best_set, int batch,
                                   int n, cudaStream_t stream) {
  if (batch <= 0) return (int)cudaSuccess;
  switch (n) {
    case 16:
      small_mwvc_mitm_kernel<16><<<batch, kThreads, 0, stream>>>(
          adj, w, best_cost, best_set);
      break;
    case 20:
      small_mwvc_mitm_kernel<20><<<batch, kThreads, 0, stream>>>(
          adj, w, best_cost, best_set);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
