// Kernel D: factored_contract — the isotropic element apply
//
//   fe[c, i, e] = (vol_e Ke_e u_e)[c, i]
//
// through the gradgrad table T[k, l, i, j] = int (dphi_i/dlam_k)
// (dphi_j/dlam_l), from grad_lambda and the volume alone:
//
//   d1[k, j]   = sum_c g[k, c] u[c, j]
//   m1[k, i]   = sum_{l, j} T[k, l, i, j] d1[l, j]
//   m2[l, i]   = sum_{k, j} T[k, l, i, j] d1[k, j]
//   q_c[km, i] = sum_j T[k, m, i, j] u[c, j]
//   G2[km]     = g_k . g_m
//   f[c, i]    = vol (mu sum_km G2[km] q_c[km, i]
//                     + sum_k g[k, c] (lam m1[k, i] + mu m2[k, i]))
//
// Replaces meshfem_tpu/sparse/contract.py::_factored_kernel (:91), the
// TQ-table backend of the routed operator (routed_ebe.py:720-731).  The TPU
// kernel pads n to the sublane tile, re-blocks T into three matrices
// (TM1, TM2, TQ) for its matrix unit, walks B 128-lane element blocks per
// grid step and bakes lam and mu into the compiled kernel.  None of that is
// carried over: T is indexed unpadded from shared memory, lam and mu are
// arguments, and the three table contractions are plain FMA loops.
//
// Layout (kernel C's): g [K1 * d, E] (row k * d + b), vol [E],
// ue [d, n, E] -> fe [d, n, E]; element index fastest.
//
// Bound on the H100: memory, as for kernel C, which computes the same
// function of the same inputs: 73 floats per element move (~24 us at the
// bench size at 3.35 TB/s) and the quadrature form needs ~1.6k
// multiply-adds per element.  The TABLE form chosen here does ~8.9k per
// element at dim 3 / deg 2 (120 for d1, 1,600 each for m1 and m2, 4,800
// for q, 48 for G2, 720 for f), ~75 us at the bench size at the 67 TFLOP/s
// float32 rate: that is this algorithm's own arithmetic time, not a bound
// of the function.  It is five times kernel C's arithmetic for the same
// result; it stays as the reference keeps its TQ kernel, behind a switch.
//
// Design: ~200 live values per element are too many for one thread, so
// FOUR warps share 32 elements.  A block is 128 threads; lane = element,
// warp w = a share of the outputs of each phase.  u, g, d1, m1, m2 live in
// shared memory as [value][lane] (conflict-free, 20.7 KB at dim 3 / deg 2).
// T (6.4 KB) is copied into shared memory once per block, and a block walks
// over many groups of 32 elements, so the copy is paid once: every T index
// is the same across a warp, so its reads are broadcasts, two floats at a
// time where n is even.  (With T in __constant__ memory, indexed by a
// register, the kernel took 1.5 ms against 0.26 ms at 248,220 elements on an
// H100: the table is larger than the constant cache's first level.)  Phases, separated by __syncthreads: load;
// d1; m1 and m2 (d1 read into registers once per thread); f (G2 and the row
// u[c, :] in registers, q_c never stored: each f[c, i] sums its own
// G2[km] T[k, m, i, j] u[c, j]).  Global loads and stores are coalesced
// (32 consecutive elements per warp).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kMaxBlocks = 132 * 8;   // enough to fill the card

// sum_j row[j] v[j]; row is in shared memory, 8-byte aligned when N is even
template <int N>
__device__ __forceinline__ float dot_row(const float* row, const float* v) {
  float acc = 0.0f;
  if constexpr (N % 2 == 0) {
    const float2* row2 = reinterpret_cast<const float2*>(row);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float2 t = row2[j];
      acc += t.x * v[2 * j];
      acc += t.y * v[2 * j + 1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) acc += row[j] * v[j];
  }
  return acc;
}

template <int DIM, int NN>
__global__ void __launch_bounds__(kLanes * kWarps)
factored_contract_kernel(const float* __restrict__ g,
                         const float* __restrict__ vol,
                         const float* __restrict__ ue,
                         const float* __restrict__ T_g,
                         float* __restrict__ fe, float lam, float mu,
                         int64_t E) {
  constexpr int K1 = DIM + 1;
  __shared__ __align__(8) float T[K1 * K1 * NN * NN];
  __shared__ float s_g[K1 * DIM][kLanes];
  __shared__ float s_u[DIM * NN][kLanes];
  __shared__ float s_d1[K1 * NN][kLanes];
  __shared__ float s_m1[K1 * NN][kLanes];
  __shared__ float s_m2[K1 * NN][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  for (int r = threadIdx.x; r < K1 * K1 * NN * NN; r += kLanes * kWarps)
    T[r] = __ldg(T_g + r);

  // every thread of a block walks the same groups, so the barriers match
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kLanes; base < E;
       base += static_cast<int64_t>(gridDim.x) * kLanes) {
    const int64_t e = base + lane;
    const bool valid = e < E;

    // load g and u (zeros past the end: every lane takes part in the syncs)
    for (int r = w; r < K1 * DIM; r += kWarps)
      s_g[r][lane] = valid ? __ldg(g + r * E + e) : 0.0f;
    for (int r = w; r < DIM * NN; r += kWarps)
      s_u[r][lane] = valid ? __ldg(ue + r * E + e) : 0.0f;
    __syncthreads();          // also orders the copy of T before its use

    // d1[k, j] = sum_c g[k, c] u[c, j]
    for (int idx = w; idx < K1 * NN; idx += kWarps) {
      const int k = idx / NN, j = idx % NN;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        acc += s_g[k * DIM + c][lane] * s_u[c * NN + j][lane];
      s_d1[idx][lane] = acc;
    }
    __syncthreads();

    // m1[k, i] = sum_lj T[k, l, i, j] d1[l, j]
    // m2[l, i] = sum_kj T[k, l, i, j] d1[k, j]   (row index "a" below)
    // d1 is read into registers once for all of this warp's outputs
    {
      float d1[K1 * NN];
#pragma unroll
      for (int r = 0; r < K1 * NN; ++r) d1[r] = s_d1[r][lane];
      for (int idx = w; idx < K1 * NN; idx += kWarps) {
        const int a = idx / NN, i = idx % NN;
        float acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll
        for (int b = 0; b < K1; ++b) {
          acc1 += dot_row<NN>(T + ((a * K1 + b) * NN + i) * NN,   // T[a,b,i,:]
                              d1 + b * NN);
          acc2 += dot_row<NN>(T + ((b * K1 + a) * NN + i) * NN,   // T[b,a,i,:]
                              d1 + b * NN);
        }
        s_m1[idx][lane] = acc1;
        s_m2[idx][lane] = acc2;
      }
    }

    // G2[km] = g_k . g_m, in registers
    float G2[K1 * K1];
#pragma unroll
    for (int k = 0; k < K1; ++k)
#pragma unroll
      for (int m = 0; m < K1; ++m) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          acc += s_g[k * DIM + c][lane] * s_g[m * DIM + c][lane];
        G2[k * K1 + m] = acc;
      }
    const float v = valid ? __ldg(vol + e) : 0.0f;
    __syncthreads();

    // f[c, i] = vol (mu sum_km G2[km] q_c[km, i]
    //                + sum_k g[k, c] (lam m1[k, i] + mu m2[k, i]))
    for (int idx = w; idx < DIM * NN; idx += kWarps) {
      const int c = idx / NN, i = idx % NN;
      float uc[NN];
#pragma unroll
      for (int j = 0; j < NN; ++j) uc[j] = s_u[c * NN + j][lane];
      float f1 = 0.0f;
#pragma unroll
      for (int km = 0; km < K1 * K1; ++km)                  // T[k, m, i, :]
        f1 += G2[km] * dot_row<NN>(T + (km * NN + i) * NN, uc);
      float f23 = 0.0f;
#pragma unroll
      for (int k = 0; k < K1; ++k)
        f23 += s_g[k * DIM + c][lane]
               * (lam * s_m1[k * NN + i][lane] + mu * s_m2[k * NN + i][lane]);
      if (valid) fe[idx * E + e] = v * (mu * f1 + f23);
    }
    __syncthreads();          // the next group overwrites s_g, s_u, s_m1/2
  }
}

template <int DIM, int NN>
void launch(const void* g, const void* vol, const void* ue, const void* T,
            void* fe, float lam, float mu, int64_t E, cudaStream_t stream) {
  const int64_t groups = (E + kLanes - 1) / kLanes;
  const unsigned blocks =
      static_cast<unsigned>(groups < kMaxBlocks ? groups : kMaxBlocks);
  factored_contract_kernel<DIM, NN><<<blocks, kLanes * kWarps, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(vol),
      static_cast<const float*>(ue), static_cast<const float*>(T),
      static_cast<float*>(fe), lam, mu, E);
}

}  // namespace

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  T is the
// gradgrad table [K1, K1, n, n] float32, row-major, in device memory.
extern "C" int factored_contract_f32(int cfg, const void* g, const void* vol,
                                     const void* ue, const void* T, void* fe,
                                     float lam, float mu, int64_t E,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    switch (cfg) {
      case 0: launch<3, 10>(g, vol, ue, T, fe, lam, mu, E, s); break;
      case 1: launch<3, 4>(g, vol, ue, T, fe, lam, mu, E, s); break;
      case 2: launch<2, 6>(g, vol, ue, T, fe, lam, mu, E, s); break;
      case 3: launch<2, 3>(g, vol, ue, T, fe, lam, mu, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
