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
// Bound on the H100: device-memory bandwidth of the x[v] row gathers (64
// bytes per edge at w = 16, ~12M directed edges per call on the road
// workload), plus the 4-byte index read per edge.  There is almost no
// arithmetic.
//
// Design: one half-warp (16 lanes) per destination row, lane c owns feature
// column c.  The 16 lanes of a row read x[v, 0:16] as one coalesced 64-byte
// segment, and read indices[e] and mask[v] as a broadcast.  Each lane keeps
// its own sum in a register and walks the row's edges in CSR order, so there
// are no atomics and every run gives the same bits.  Widths above 16 loop
// over column blocks of 16.  No shared memory, no allocation; the caller
// passes the output and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;           // lanes per row (one half-warp)
constexpr int kThreads = 256;        // 16 rows per block

// MaskKind: 0 = no mask, 1 = float32 mask, 2 = uint8 mask (0/1)
template <int MaskKind>
__global__ void __launch_bounds__(kThreads)
csr_aggregate_kernel(const float* __restrict__ x,
                     const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const void* __restrict__ mask,
                     float* __restrict__ out, int n, int w) {
  const int lane = threadIdx.x % kLanes;
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  if (row >= n) return;
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  for (int c = lane; c < w; c += kLanes) {
    float acc = 0.f;
    for (int e = beg; e < end; ++e) {
      const int v = __ldg(indices + e);
      float xv = __ldg(x + (int64_t)v * w + c);
      if (MaskKind == 1) {
        xv = __fmul_rn(xv, __ldg((const float*)mask + v));
      } else if (MaskKind == 2) {
        xv = __fmul_rn(xv, (float)__ldg((const uint8_t*)mask + v));
      }
      acc = __fadd_rn(acc, xv);
    }
    out[row * w + c] = acc;
  }
}

}  // namespace

extern "C" int csr_aggregate_f32(const float* x, const int* indptr,
                                 const int* indices, const void* mask,
                                 int mask_kind, float* out, int n, int w,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int rows_per_block = kThreads / kLanes;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  switch (mask_kind) {
    case 0:
      csr_aggregate_kernel<0><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, w);
      break;
    case 1:
      csr_aggregate_kernel<1><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, w);
      break;
    case 2:
      csr_aggregate_kernel<2><<<blocks, kThreads, 0, stream>>>(
          x, indptr, indices, mask, out, n, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
