// Kernel F: route_window, windowed lane routing.
//
//   out[v, s, l] = 0 <= widx[v, s, l] < chain
//                  ? x[win0[v] + widx[v, s, l], lidx[v, s, l] & 127] : 0
//
// x [NT, 128] float32, win0 [NV] int32, widx / lidx / out [NV, S, 128]
// (S = 8 in the probe); window rows outside [0, NT) read as 0.
//
// Replaces experiments/probe_route.py::route_kernel (:22, pallas_call at
// :44), the TPU micro-benchmark of the routed gather: each output vreg
// [8, 128] takes its 1,024 values from a CHAIN of 128-lane source windows
// starting at win0[v], by broadcast row + lane gather + masked accumulate
// over the chain (CHAIN gathers and selects a vreg).  A Hopper thread
// addresses any word, so one read of the staged window replaces the chain
// loop.
//
// Bound on the H100: memory.  At the probe's shapes (NV = 7,530, NT =
// 2,797, CHAIN = 4, probe_route.py:63-67) it reads widx and lidx (30.8 MB
// each), x (1.4 MB) and win0 and writes out (30.8 MB): ~94 MB, 0.028 ms at
// 3.35 TB/s.
//
// Design: a block of 256 threads takes a group of kGroup = 4 consecutive v
// and stages their CHAIN x 128 windows (2 KB each at CHAIN = 4) into shared
// memory with coalesced loads; each thread then routes 4 consecutive
// values at a time: one 16-byte load each of widx and lidx (evict-first),
// four shared-memory reads, one 16-byte streaming store.  Every byte of
// the three large arrays moves once, in order; x's rows are read once per
// group from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kGroup = 4;

__device__ __forceinline__ float route_one(const float* win, int w, int l,
                                           int chain) {
  return static_cast<unsigned>(w) < static_cast<unsigned>(chain)
             ? win[w * kLanes + (l & (kLanes - 1))]
             : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
route_window_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ win0,
                    const int32_t* __restrict__ widx,
                    const int32_t* __restrict__ lidx,
                    float* __restrict__ out, int chain, int64_t n_rows,
                    int64_t n_v, int values) {
  extern __shared__ float win[];                   // [kGroup][chain][128]
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kGroup;
  const int64_t rest = n_v - v0;
  const int nv = rest < kGroup ? static_cast<int>(rest) : kGroup;
  const int wlen = chain * kLanes;
  for (int i = threadIdx.x; i < nv * wlen; i += kThreads) {
    const int g = i / wlen;
    const int r = i - g * wlen;
    const int64_t row = static_cast<int64_t>(__ldg(win0 + v0 + g)) + r / kLanes;
    win[i] = (row >= 0 && row < n_rows)
                 ? __ldg(x + row * kLanes + (r & (kLanes - 1)))
                 : 0.0f;
  }
  __syncthreads();
  const int64_t base = v0 * values;                // values % 4 == 0
  const int4* __restrict__ w4 = reinterpret_cast<const int4*>(widx + base);
  const int4* __restrict__ l4 = reinterpret_cast<const int4*>(lidx + base);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out + base);
  const int quads = values / 4;
  for (int i = threadIdx.x; i < nv * quads; i += kThreads) {
    const float* wg = win + (i / quads) * wlen;
    const int4 w = __ldcs(w4 + i);
    const int4 l = __ldcs(l4 + i);
    float4 o;
    o.x = route_one(wg, w.x, l.x, chain);
    o.y = route_one(wg, w.y, l.y, chain);
    o.z = route_one(wg, w.z, l.z, chain);
    o.w = route_one(wg, w.w, l.w, chain);
    __stcs(o4 + i, o);
  }
}

}  // namespace

// values = S * 128 values a v (a multiple of 4); the caller passes 16-byte
// aligned widx, lidx and out.
extern "C" int route_window_f32(const void* x, const void* win0,
                                const void* widx, const void* lidx, void* out,
                                int chain, int64_t n_rows, int64_t n_v,
                                int values, void* stream) {
  if (n_v > 0) {
    const size_t smem =
        static_cast<size_t>(kGroup) * chain * kLanes * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          route_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((n_v + kGroup - 1) / kGroup);
    route_window_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(win0),
        static_cast<const int32_t*>(widx), static_cast<const int32_t*>(lidx),
        static_cast<float*>(out), chain, n_rows, n_v, values);
  }
  return static_cast<int>(cudaGetLastError());
}
