// Kernel B: segment_sum_csr.
//
//   out[p, v] = sum_{k = offsets[v]}^{offsets[v+1]-1} src[p, perm[k]]
//
// with perm the slot ids sorted STABLY by destination, so each destination
// sums its contributions in increasing slot order.
//
// Replaces meshfem_tpu/sparse/route.py::_reduce_kernel_p (:162, planes
// mode), ::_reduce_kernel (:207, one plane) and the whole SumPlan scatter
// ladder of RoutedEBE (routed_ebe.py:74-123, 279-311, 558-623), whose
// windows, caps and rungs work around the TPU's lane-rigid gather.  The
// float64 instance also carries the f64 EBEKernel residual operator
// (sparse/scatter.py::ScatterPlan in the reference).
//
// Bound on the H100: memory.  It reads the contributions (4 or 8 B/slot/
// plane), perm (4 B/slot) and offsets (4 B/node) and writes the output; at
// the bench size in f32 that is ~51 MB, ~15 us at 3.35 TB/s.  Design: one
// thread per destination walks its CSR run, reads each perm entry once for
// all planes (up to 4 planes per pass, accumulated in registers) and
// writes each output once.  No atomics: the summation order is fixed by the
// plan, so results are bit-identical run to run (route.py:27-28,
// scatter.py:15-17); Tensor.index_add_ on CUDA would use float atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanesPerPass = 4;

template <typename T>
__global__ void segment_sum_csr_kernel(const T* __restrict__ src,
                                       const int32_t* __restrict__ perm,
                                       const int32_t* __restrict__ offsets,
                                       T* __restrict__ out, int planes,
                                       int64_t n_src, int64_t n_out) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_out) return;
  const int32_t beg = __ldg(offsets + v);
  const int32_t end = __ldg(offsets + v + 1);
  for (int p0 = 0; p0 < planes; p0 += kPlanesPerPass) {
    T acc[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) acc[q] = T(0);
    for (int32_t k = beg; k < end; ++k) {
      const int64_t s = __ldg(perm + k);
#pragma unroll
      for (int q = 0; q < kPlanesPerPass; ++q) {
        if (p0 + q < planes) acc[q] += __ldg(src + (p0 + q) * n_src + s);
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) {
      if (p0 + q < planes) out[(p0 + q) * n_out + v] = acc[q];
    }
  }
}

template <typename T>
int launch(const void* src, const void* perm, const void* offsets, void* out,
           int planes, int64_t n_src, int64_t n_out, void* stream) {
  if (n_out > 0) {
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((n_out + threads - 1) / threads);
    segment_sum_csr_kernel<T><<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<T*>(out), planes,
        n_src, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_sum_csr_f32(const void* src, const void* perm,
                                   const void* offsets, void* out, int planes,
                                   int64_t n_src, int64_t n_out,
                                   void* stream) {
  return launch<float>(src, perm, offsets, out, planes, n_src, n_out, stream);
}

extern "C" int segment_sum_csr_f64(const void* src, const void* perm,
                                   const void* offsets, void* out, int planes,
                                   int64_t n_src, int64_t n_out,
                                   void* stream) {
  return launch<double>(src, perm, offsets, out, planes, n_src, n_out, stream);
}
