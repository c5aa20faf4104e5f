// Kernel B: segment_sum, the deterministic scatter slots -> nodes.
//
//   out(v, p) = sum_{k = offsets[v]}^{offsets[v+1]-1} src(perm[k], p)
//
// with perm the contribution ids sorted STABLY by destination, so each
// destination sums its contributions in increasing order, and
//
//   src(r, p) = src[r * src_row_stride + p * src_plane_stride]
//   out(v, p) = out[v * out_node_stride + p * out_plane_stride]
//
// so one kernel takes contribution rows [R, P] or planes [P, R] and writes
// node rows [N, P] or planes [P, N], each without a copy.
//
// Replaces meshfem_tpu/sparse/route.py::_reduce_kernel_p (:162, planes
// mode), ::_reduce_kernel (:207, one plane) and the whole SumPlan scatter
// ladder of RoutedEBE (routed_ebe.py:74-123, 279-311, 558-623), whose
// windows, caps and rungs work around the TPU's lane-rigid gather.  The
// float64 instance also carries the f64 EBEKernel residual operator
// (sparse/scatter.py::ScatterPlan in the reference).
//
// Bound on the H100: memory.  It reads the contributions (4 or 8 B a row
// and plane), perm (4 B a row) and offsets (4 B a node) once and writes the
// output once: at the block apply's 18 planes on the periodic cell ~214 MB
// in f32, 0.064 ms at 3.35 TB/s (f64 0.125 ms).
//
// Design: one thread per (destination, plane) value, t = v * P + p, each
// walking its destination's run once and accumulating in one register, in
// the plan's order (the adds are never reassociated); no atomics, so every
// run gives the same bits (route.py:27-28, scatter.py:15-17), and a rows
// call and a planes call given the same contributions in the same order
// give the same bits.  Tensor.index_add_ on CUDA would use float atomics.
//   - Sectors: with rows input, the P lanes of a destination read each
//     contribution's row whole, side by side (72 bytes, 3 sectors, at 18
//     float planes), and its perm entry from one address.  The kernel this
//     one replaces ran one thread per destination over 4 planes a pass:
//     at 18 planes five walks, each reading perm again and one sector per
//     value.
//   - Run imbalance: P2 vertex nodes have runs several times longer than
//     edge nodes (24 against 4 to 6 on a Kuhn grid).  A warp now holds
//     ceil(32 / P) destinations (2 at 18 planes, 11 at 3) instead of 32,
//     so a long run stalls the few lanes of its own group and few others.
//     Staging a block's contribution rows in shared memory with the loads
//     spread evenly over its threads, then adding from there, was tried
//     beside this kernel on the card: level with it at 3 values a node and
//     slower at 18, where the block's barriers cost more than the
//     imbalance they remove.
//   - Latency: a thread walks its run in rounds of 8 contributions, all 8
//     perm loads issued together, then all 8 value loads (predicated past
//     the run's end), then the 8 adds in order; a vertex run costs 3 round
//     trips of two dependent loads, an edge run one.  The plane count of
//     the common cases (1, 3, 9, 18) is a template constant, so the
//     thread's (destination, plane) split is a multiply, not a division.
//   - L2: the contributions are read with the default caching.  A sector
//     holds parts of the rows of several destinations, read at different
//     times; with evict-first loads (__ldcs) the card fetched it again
//     from memory, and the kernel was slower in every case tried.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRound = 8;

// PC: the plane count as a compile-time constant, 0 for a runtime one.
template <typename T, int PC>
__global__ void segment_sum_kernel(const T* __restrict__ src,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ offsets,
                                   T* __restrict__ out, uint32_t planes_rt,
                                   int64_t src_row_stride,
                                   int64_t src_plane_stride,
                                   int64_t out_node_stride,
                                   int64_t out_plane_stride,
                                   uint32_t n_values) {
  const uint32_t planes = PC > 0 ? PC : planes_rt;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_values) return;
  const uint32_t v = t / planes;
  const uint32_t p = t - v * planes;
  const int32_t beg = __ldg(offsets + v);
  const int32_t end = __ldg(offsets + v + 1);
  const T* __restrict__ col = src + p * src_plane_stride;
  T acc = T(0);
  for (int32_t k = beg; k < end; k += kRound) {
    int32_t r[kRound];
    T x[kRound];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      r[i] = k + i < end ? __ldg(perm + k + i) : 0;
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      x[i] = k + i < end ? __ldg(col + r[i] * src_row_stride) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      if (k + i < end) acc += x[i];
    }
  }
  out[v * out_node_stride + p * out_plane_stride] = acc;
}

template <typename T>
int launch(const void* src, const void* perm, const void* offsets, void* out,
           int planes, int64_t src_row_stride, int64_t src_plane_stride,
           int64_t out_node_stride, int64_t out_plane_stride, int64_t n_out,
           void* stream) {
  const uint32_t n_values =
      static_cast<uint32_t>(n_out) * static_cast<uint32_t>(planes);
  if (n_values > 0) {
    const int threads = 256;
    const unsigned blocks = (n_values + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto kernel = segment_sum_kernel<T, 0>;
    switch (planes) {
      case 1: kernel = segment_sum_kernel<T, 1>; break;
      case 3: kernel = segment_sum_kernel<T, 3>; break;
      case 9: kernel = segment_sum_kernel<T, 9>; break;
      case 18: kernel = segment_sum_kernel<T, 18>; break;
      default: break;
    }
    kernel<<<blocks, threads, 0, st>>>(
        static_cast<const T*>(src), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<T*>(out),
        static_cast<uint32_t>(planes), src_row_stride, src_plane_stride,
        out_node_stride, out_plane_stride, n_values);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller guarantees n_out * planes < 2^31.
extern "C" int segment_sum_f32(const void* src, const void* perm,
                               const void* offsets, void* out, int planes,
                               int64_t src_row_stride,
                               int64_t src_plane_stride,
                               int64_t out_node_stride,
                               int64_t out_plane_stride, int64_t n_out,
                               void* stream) {
  return launch<float>(src, perm, offsets, out, planes, src_row_stride,
                       src_plane_stride, out_node_stride, out_plane_stride,
                       n_out, stream);
}

extern "C" int segment_sum_f64(const void* src, const void* perm,
                               const void* offsets, void* out, int planes,
                               int64_t src_row_stride,
                               int64_t src_plane_stride,
                               int64_t out_node_stride,
                               int64_t out_plane_stride, int64_t n_out,
                               void* stream) {
  return launch<double>(src, perm, offsets, out, planes, src_row_stride,
                        src_plane_stride, out_node_stride, out_plane_stride,
                        n_out, stream);
}
