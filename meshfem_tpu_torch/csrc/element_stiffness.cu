// Kernel E: element_stiffness — fused float32 element-stiffness assembly
//
//   Ke[e, :] = vol_e (g_e (x) g_e) @ M
//
// with g_e = grad_lambda[e] flattened (gdim = (K+1) d floats) and M the
// constant fused material/integral matrix [gdim^2, (n d)^2]
// (ops/element_matrices.fused_matrix_for).
//
// Replaces meshfem_tpu/kernels/element_stiffness.py::_asm_kernel (:42), the
// float32 drop-in for element_elasticity_fused_apply.  The TPU kernel pads
// (n d)^2 = 900 to 1024 lanes, passes the volume as a [BE, 1] block and
// builds the Gram block by lane concatenation for one matrix-unit product;
// none of that is carried over.  The product is written out by hand as a
// register-tiled float32 FMA loop (no tensor cores: the reference asks for
// full float32, and TF32 would leave ~1e-3 error in the operator).
//
// Bound on the H100: memory, ~0.30 ms for the 1.0 GB it writes at the
// bench size (E = 279,936, P2 tets) at 3.35 TB/s.  The function itself
// needs few operations: contracting the material into the Gram block first
// (H[k,l,c,f], 1,296 multiply-adds) and the table second (900 x 16) gives
// Ke in ~15.7k multiply-adds per element, ~0.13 ms at the 67 TFLOP/s
// float32 rate.  The ONE-product form kept here from the TPU kernel does
// 2 gdim^2 (n d)^2 flops per element, 72.6 GFLOP and ~1.08 ms at that rate:
// that is this algorithm's own arithmetic time, not a bound of the function.
//
// Design: a block of 256 threads owns a tile of 128 elements x 64 columns
// of Ke.  M has 144 x 900 floats (518 KB), more than an SM's shared memory,
// so its COLUMNS are tiled: the block keeps M[:, c0:c0+64] (36 KB) in
// dynamic shared memory, and M stays resident in the 50 MB L2 for the other
// blocks.  The Gram block gg[e, a * gdim + b] = vol_e g[e, a] g[e, b] is
// never stored: the tile's g and vol * g sit in shared memory as
// [a][element] (12 KB) and each thread forms its products on the fly, so
// four blocks fit on an SM.  Thread (ty, tx), ty = 0..15, tx = 0..15,
// accumulates 8 elements x 4 columns in registers: per step (a, b) of the
// gdim^2-long reduction it reads one float4 of M and two float4 of g (all
// conflict-free or broadcast), forms 8 products and does 32 FMAs.  Each
// thread stores float4s, a half-warp 256 consecutive bytes of one element's
// row: coalesced.  Column tiles are the fastest block index, so the 15
// tiles of one element tile run together and fill whole rows of Ke.
// (n d)^2 must be a multiple of 4 (it is 900, 144, 144 and 36 for the
// supported elements).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBE = 128;      // elements per tile
constexpr int kBC = 64;       // columns per tile
constexpr int kTE = 8;        // elements per thread
constexpr int kTC = 4;        // columns per thread
constexpr int kThreads = (kBE / kTE) * (kBC / kTC);   // 256
constexpr int kMaxG = 12;     // gdim at dim 3

__global__ void __launch_bounds__(kThreads)
element_stiffness_kernel(const float* __restrict__ gl,
                         const float* __restrict__ vol,
                         const float* __restrict__ M, float* __restrict__ Ke,
                         int gdim, int nd2, int n_col_tiles, int64_t E) {
  extern __shared__ float4 smem4[];
  const int KK = gdim * gdim;
  float* s_M = reinterpret_cast<float*>(smem4);        // [KK][kBC]
  __shared__ __align__(16) float s_g[kMaxG][kBE];      // g[a][element]
  __shared__ __align__(16) float s_gv[kMaxG][kBE];     // vol * g

  const int tid = threadIdx.x;
  const int64_t bid = blockIdx.x;
  const int c0 = static_cast<int>(bid % n_col_tiles) * kBC;
  const int64_t e0 = (bid / n_col_tiles) * kBE;

  // this tile's geometry (zeros past the end) and M column tile
  for (int idx = tid; idx < kBE * gdim; idx += kThreads) {
    const int el = idx / gdim, a = idx % gdim;
    const int64_t e = e0 + el;
    const float gv = e < E ? __ldg(gl + e * gdim + a) : 0.0f;
    const float v = e < E ? __ldg(vol + e) : 0.0f;
    s_g[a][el] = gv;
    s_gv[a][el] = v * gv;
  }
  for (int idx = tid; idx < KK * kBC; idx += kThreads) {
    const int p = idx / kBC, c = c0 + idx % kBC;
    s_M[idx] = c < nd2 ? __ldg(M + static_cast<int64_t>(p) * nd2 + c) : 0.0f;
  }
  __syncthreads();

  const int tx = tid % (kBC / kTC);
  const int ty = tid / (kBC / kTC);
  if (c0 + tx * kTC >= nd2) return;          // no barrier follows

  float acc[kTE][kTC];
#pragma unroll
  for (int i = 0; i < kTE; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.0f;

  const float4* M4 = reinterpret_cast<const float4*>(s_M) + tx;
  for (int a = 0; a < gdim; ++a) {
    const float4* A4 = reinterpret_cast<const float4*>(s_gv[a]) + ty * 2;
    const float4 a0 = A4[0], a1 = A4[1];
    const float ga[kTE] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll 4
    for (int b = 0; b < gdim; ++b) {
      const float4 mv = M4[(a * gdim + b) * (kBC / 4)];
      const float4* B4 = reinterpret_cast<const float4*>(s_g[b]) + ty * 2;
      const float4 b0 = B4[0], b1 = B4[1];
      const float gb[kTE] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTE; ++i) {
        const float gg = ga[i] * gb[i];
        acc[i][0] += gg * mv.x;
        acc[i][1] += gg * mv.y;
        acc[i][2] += gg * mv.z;
        acc[i][3] += gg * mv.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTE; ++i) {
    const int64_t e = e0 + ty * kTE + i;
    if (e < E) {
      float4* dst = reinterpret_cast<float4*>(Ke + e * nd2 + c0 + tx * kTC);
      *dst = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

}  // namespace

// gl [E, gdim], vol [E], M [gdim^2, nd2] float32 row-major -> Ke [E, nd2].
// gdim <= 12, nd2 a multiple of 4, Ke 16-byte aligned.
extern "C" int element_stiffness_f32(const void* gl, const void* vol,
                                     const void* M, void* Ke, int gdim,
                                     int nd2, int64_t E, void* stream) {
  if (gdim < 1 || gdim > kMaxG || nd2 < 4 || nd2 % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  const int KK = gdim * gdim;
  const size_t smem = static_cast<size_t>(KK) * kBC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      element_stiffness_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_col_tiles = (nd2 + kBC - 1) / kBC;
  const int64_t n_el_tiles = (E + kBE - 1) / kBE;
  const int64_t blocks = n_el_tiles * n_col_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  element_stiffness_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gl), static_cast<const float*>(vol),
      static_cast<const float*>(M), static_cast<float*>(Ke), gdim, nd2,
      n_col_tiles, E);
  return static_cast<int>(cudaGetLastError());
}
