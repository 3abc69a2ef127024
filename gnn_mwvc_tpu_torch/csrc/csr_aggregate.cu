// K1: deterministic masked CSR neighbour sum for the GNN graph layers.
//
//   out[u, c] = sum over v in N(u), in CSR order, of x[v, c] * mask[v]
//
// Replaces the JAX package's TPU aggregation paths,
// gnn_mwvc_tpu/ops/aggregate.py::ell_segment_sum (multi-level ELL gathers and
// tree sums) and gnn_mwvc_tpu/ops/blocked.py::blocked_segment_sum (windowed
// one-hot matmuls on the MXU).  Both exist only because scatter is slow on a
// TPU; on a GPU a row-parallel CSR walk needs neither a plan nor a scatter.
//
// Bound on the H100: device-memory bytes.  Counting each input once and the
// output once, the road workload's sticky forward (1.44M rows, 11.6M
// directed edges, w = 16, f32 mask) moves 242 MB: 0.072 ms at 3.35 TB/s.
// There is almost no arithmetic.  A row walk is held back by latency (an
// index load, then a gather of x[v] that depends on it) and by the gathers
// themselves: every x row is read once per edge, 64 bytes at w = 16, so
// 746 MB cross from L2 even when the graph's locality keeps them there.
//
// Design: four lanes per row, eight rows per warp.  On the vector path
// (w % 4 == 0 and x, out 16-byte aligned) lane r of a row owns the float4
// columns r, r + 4, ...; at w = 16 one float4 each, so a row's x[v] is one
// 64-byte segment.  A row's edges go in steps of 4: each lane loads one
// index (and the mask value it points at), the group exchanges them with
// __shfl_sync, and every lane issues its 4 gathers before it sums.  Each
// group walks 2 consecutive rows and loads the second row's end offset and
// first indices while it gathers the first row.  Rows per group, edges per
// step and the block size were picked on the H100 at the road workload's
// shape by gnn_mwvc_tpu_torch/tools/k1_timing.py --sweep, which builds and
// times the other values (2 rows a group: 8% less time masked, 12%
// unmasked, than 1).  Other widths and unaligned x take the scalar path:
// the same walk, one float a lane.
//
// The arithmetic is the plain version's, in its order: x[v] * mask[v]
// rounded (__fmul_rn), then added (__fadd_rn) to a sum that starts at 0,
// one edge after another in CSR order.  There are no atomics, so every run
// gives the same bits, and they equal csr_aggregate_plain run on the CPU,
// whose index_add_ adds in that order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;            // lanes per row
constexpr int kStep = 4;             // edges per step (kStep / kGroup each)
constexpr int kRows = 2;             // consecutive rows per group
constexpr int kThreads = 128;        // 32 groups, 64 rows per block

template <int MaskKind>
__device__ __forceinline__ float mask_at(const void* mask, int v) {
  if (MaskKind == 1) return __ldg((const float*)mask + v);
  if (MaskKind == 2) return (float)__ldg((const uint8_t*)mask + v);
  return 1.f;
}

__device__ __forceinline__ float4 ldg_units(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_units(const float* p) { return __ldg(p); }

template <int MaskKind>
__device__ __forceinline__ float scaled(float x, float m) {
  return MaskKind == 0 ? x : __fmul_rn(x, m);
}

template <int MaskKind>
__device__ __forceinline__ void add_edge(float& acc, float x, float m) {
  acc = __fadd_rn(acc, scaled<MaskKind>(x, m));
}

template <int MaskKind>
__device__ __forceinline__ void add_edge(float4& acc, float4 x, float m) {
  acc.x = __fadd_rn(acc.x, scaled<MaskKind>(x.x, m));
  acc.y = __fadd_rn(acc.y, scaled<MaskKind>(x.y, m));
  acc.z = __fadd_rn(acc.z, scaled<MaskKind>(x.z, m));
  acc.w = __fadd_rn(acc.w, scaled<MaskKind>(x.w, m));
}

__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }

// One step of a row: up to kStep edges whose indices the group's lanes
// hold (kStep / kGroup each, -1 past the row's end), added to acc in order.
template <int MaskKind, typename Unit>
__device__ __forceinline__ void add_step(const Unit* __restrict__ x,
                                         const void* __restrict__ mask,
                                         const int (&my_v)[kStep / kGroup],
                                         unsigned group_mask, int units,
                                         int c, bool active, Unit& acc) {
  float my_m[kStep / kGroup];
#pragma unroll
  for (int h = 0; h < kStep / kGroup; ++h) {
    my_m[h] = MaskKind != 0 && my_v[h] >= 0 ? mask_at<MaskKind>(mask, my_v[h])
                                            : 0.f;
  }
  int v[kStep];
  Unit xv[kStep];
  // all gathers first, so none waits on a mask value
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    v[k] = __shfl_sync(group_mask, my_v[k / kGroup], k % kGroup, kGroup);
    if (active && v[k] >= 0) {
      xv[k] = ldg_units(x + (int64_t)v[k] * units + c);
    } else {
      zero(xv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    const float m = MaskKind == 0 ? 1.f
                                  : __shfl_sync(group_mask, my_m[k / kGroup],
                                                k % kGroup, kGroup);
    if (v[k] >= 0) add_edge<MaskKind>(acc, xv[k], m);
  }
}

// Indices e0 + h * kGroup + r of the step starting at e0, -1 from `end` on.
__device__ __forceinline__ void load_step(const int* __restrict__ indices,
                                          int e0, int end, int r,
                                          int (&my_v)[kStep / kGroup]) {
#pragma unroll
  for (int h = 0; h < kStep / kGroup; ++h) {
    const int e = e0 + h * kGroup + r;
    my_v[h] = e < end ? __ldg(indices + e) : -1;
  }
}

// Unit is float4 (vector path) or float (scalar path); units = w / 4 or w.
// Each group of kGroup lanes walks kRows consecutive rows.  While it
// gathers one row it has the next row's end offset and first kStep
// indices in flight (the next row starts where this one ends).
template <int MaskKind, typename Unit>
__global__ void __launch_bounds__(kThreads)
csr_aggregate_kernel(const Unit* __restrict__ x,
                     const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const void* __restrict__ mask,
                     Unit* __restrict__ out, int n, int units) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (kGroup - 1);
  const unsigned group_mask = 0xFu << (lane & ~(kGroup - 1));
  int64_t row =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kGroup * kRows;
  if (row >= n) return;  // the whole group leaves together
  const int64_t last = row + kRows < n ? row + kRows : n;
  int beg = __ldg(indptr + row);
  int end = __ldg(indptr + row + 1);
  const int nnz = __ldg(indptr + n);  // bounds the next row's prefetch
  int cur[kStep / kGroup];
  load_step(indices, beg, end, r, cur);
  // every lane of the group runs the same trip counts, so the group's
  // shuffles always see all four lanes
  for (; row < last; ++row) {
    const bool more = row + 1 < last;
    const int next_end = more ? __ldg(indptr + row + 2) : end;
    int next[kStep / kGroup];
    load_step(indices, end, more ? nnz : end, r, next);
    for (int c0 = 0; c0 < units; c0 += kGroup) {
      const int c = c0 + r;
      const bool active = c < units;
      Unit acc;
      zero(acc);
      add_step<MaskKind>(x, mask, cur, group_mask, units, c, active, acc);
      for (int e0 = beg + kStep; e0 < end; e0 += kStep) {
        int step[kStep / kGroup];
        load_step(indices, e0, end, r, step);
        add_step<MaskKind>(x, mask, step, group_mask, units, c, active, acc);
      }
      if (active) out[row * units + c] = acc;
    }
#pragma unroll
    for (int h = 0; h < kStep / kGroup; ++h) {
      cur[h] = end + h * kGroup + r < next_end ? next[h] : -1;
    }
    beg = end;
    end = next_end;
  }
}

template <typename Unit>
int launch(const Unit* x, const int* indptr, const int* indices,
           const void* mask, int mask_kind, Unit* out, int n, int units,
           cudaStream_t stream) {
  const int rows_per_block = kThreads / kGroup * kRows;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  switch (mask_kind) {
    case 0:
      csr_aggregate_kernel<0, Unit><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, units);
      break;
    case 1:
      csr_aggregate_kernel<1, Unit><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, units);
      break;
    case 2:
      csr_aggregate_kernel<2, Unit><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, units);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int csr_aggregate_f32(const float* x, const int* indptr,
                                 const int* indices, const void* mask,
                                 int mask_kind, float* out, int n, int w,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (w % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0) {
    return launch((const float4*)x, indptr, indices, mask, mask_kind,
                  (float4*)out, n, w / 4, stream);
  }
  return launch(x, indptr, indices, mask, mask_kind, out, n, w, stream);
}
