// Kernel A: gather_planes.
//
//   out[p, s] = ids[s] >= 0 ? src[p, ids[s]] : 0        (p < planes)
//
// Replaces meshfem_tpu/sparse/route.py::_copy_kernel_p (:139, planes mode)
// and ::_copy_kernel (:187, one plane): the routed gather slot <- node of
// every RoutedEBE apply.  The TPU kernels route 128-lane windows through
// chain buckets because Mosaic's gather cannot cross lanes; a Hopper thread
// loads any address, so the whole plan set reduces to one int32 index per
// slot.
//
// Bound on the H100: memory.  Each call moves ids (4 B/slot), the source
// planes (4 B/node/plane) and the output (4 B/slot/plane); at the bench
// size (3 planes, 2,799,360 slots, 389,017 nodes) that is ~50 MB, ~15 us
// at 3.35 TB/s.  Design: one thread per slot reads its index ONCE and loops
// over the planes (what the TPU's planes mode bought); slots are laid out
// element-fastest (s = a * E + e), so neighbouring threads write
// neighbouring addresses and the source reads follow the first-touch node
// numbering, which keeps them mostly inside a few cache lines per warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_planes_kernel(const float* __restrict__ src,
                                     const int32_t* __restrict__ ids,
                                     float* __restrict__ out, int planes,
                                     int64_t n_src, int64_t n_slots) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int32_t id = __ldg(ids + s);
  for (int p = 0; p < planes; ++p) {
    out[p * n_slots + s] = id >= 0 ? __ldg(src + p * n_src + id) : 0.0f;
  }
}

}  // namespace

extern "C" int gather_planes_f32(const void* src, const void* ids, void* out,
                                 int planes, int64_t n_src, int64_t n_slots,
                                 void* stream) {
  if (n_slots > 0) {
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((n_slots + threads - 1) / threads);
    gather_planes_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), planes, n_src, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
