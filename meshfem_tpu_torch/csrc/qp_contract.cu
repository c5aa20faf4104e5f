// Kernel C: qp_contract — the matrix-free isotropic element apply
//
//   fe[c, i, e] = (vol_e Ke_e u_e)[c, i]
//
// computed from grad_lambda and the volume alone, as strain -> stress ->
// force at the quadrature points of qp_tables(K, deg):
//
//   gphi[i, b] = sum_k dN[q, i, k] g[k, b]          (shape gradients)
//   G[c, b]    = sum_i u[c, i] gphi[i, b]            (displacement gradient)
//   S[c, b]    = (mu (G + G^T) + lam tr(G) I)[c, b] * W[q] * vol
//   f[c, i]   += sum_b gphi[i, b] S[c, b]
//
// Replaces meshfem_tpu/sparse/contract.py::_qp_kernel (:232), the factored
// routed backend on the TPU (routed_ebe.py:732-737).  The TPU kernel packs
// 1024 elements per [8, 128] superblock so that every op is a full vreg and
// bakes lam and mu into the compiled kernel; here one thread owns one
// element, keeps u [d, n] and f [d, n] in registers, and takes lam and mu
// as arguments.
//
// Layout: g [K1 * d, E] (row k * d + b), vol [E], ue [d, n, E] -> fe
// [d, n, E]; element index fastest, so a warp's loads and stores are
// coalesced.  dN [Q, n, K1] and W [Q] live in __constant__ memory, one
// table per (dim, deg) configuration, uploaded once per device by
// qp_set_tables.
//
// Bound on the H100: memory.  73 f32 per element move (12 g + 1 vol + 30 u
// in, 30 f out): 82 MB at the bench size, ~24 us at 3.35 TB/s; the
// arithmetic (~2.5 kFLOP per element at dim 3 / deg 2) is ~10 us at the
// 67 TFLOP/s f32 peak.  Every loop is unrolled at compile time so the
// per-element state stays in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 4;
constexpr int kMaxN = 10;
constexpr int kMaxK1 = 4;
constexpr int kNumCfg = 4;  // (dim, deg) = (3, 2), (3, 1), (2, 2), (2, 1)
constexpr int kTab = kMaxQ * kMaxN * kMaxK1;

__constant__ float c_dN[kNumCfg * kTab];
__constant__ float c_W[kNumCfg * kMaxQ];

template <int DIM, int NN, int Q, int CFG>
__global__ void qp_contract_kernel(const float* __restrict__ g,
                                   const float* __restrict__ vol,
                                   const float* __restrict__ ue,
                                   float* __restrict__ fe, float lam, float mu,
                                   int64_t E) {
  constexpr int K1 = DIM + 1;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= E) return;

  float gl[K1][DIM];
#pragma unroll
  for (int k = 0; k < K1; ++k)
#pragma unroll
    for (int b = 0; b < DIM; ++b) gl[k][b] = __ldg(g + (k * DIM + b) * E + e);
  float u[DIM][NN];
  float f[DIM][NN];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      u[c][i] = __ldg(ue + (c * NN + i) * E + e);
      f[c][i] = 0.0f;
    }
  const float v = __ldg(vol + e);

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float gphi[NN][DIM];
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < K1; ++k)
          acc += c_dN[CFG * kTab + (q * NN + i) * K1 + k] * gl[k][b];
        gphi[i][b] = acc;
      }
    float G[DIM][DIM];
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NN; ++i) acc += u[c][i] * gphi[i][b];
        G[c][b] = acc;
      }
    float tr = 0.0f;
#pragma unroll
    for (int c = 0; c < DIM; ++c) tr += G[c][c];
    const float wv = v * c_W[CFG * kMaxQ + q];
    float S[DIM][DIM];
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        float s = mu * (G[c][b] + G[b][c]);
        if (c == b) s += lam * tr;
        S[c][b] = s * wv;
      }
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int b = 0; b < DIM; ++b)
#pragma unroll
        for (int c = 0; c < DIM; ++c) f[c][i] += gphi[i][b] * S[c][b];
  }

#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int i = 0; i < NN; ++i) fe[(c * NN + i) * E + e] = f[c][i];
}

template <int DIM, int NN, int Q, int CFG>
void launch(const void* g, const void* vol, const void* ue, void* fe,
            float lam, float mu, int64_t E, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((E + threads - 1) / threads);
  qp_contract_kernel<DIM, NN, Q, CFG><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(vol),
      static_cast<const float*>(ue), static_cast<float*>(fe), lam, mu, E);
}

}  // namespace

// Upload the quadrature tables of configuration ``cfg``: dN [Q, n, K1] and
// W [Q], float32, row-major.  Synchronous; call once per device and cfg
// before the first qp_contract_f32 of that cfg.
extern "C" int qp_set_tables(int cfg, const void* dN, int n_dN, const void* W,
                             int n_W) {
  if (cfg < 0 || cfg >= kNumCfg || n_dN > kTab || n_W > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemcpyToSymbol(c_dN, dN, n_dN * sizeof(float),
                                       cfg * kTab * sizeof(float));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbol(c_W, W, n_W * sizeof(float),
                           cfg * kMaxQ * sizeof(float));
  return static_cast<int>(err);
}

extern "C" int qp_contract_f32(int cfg, const void* g, const void* vol,
                               const void* ue, void* fe, float lam, float mu,
                               int64_t E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    switch (cfg) {
      case 0: launch<3, 10, 4, 0>(g, vol, ue, fe, lam, mu, E, s); break;
      case 1: launch<3, 4, 1, 1>(g, vol, ue, fe, lam, mu, E, s); break;
      case 2: launch<2, 6, 3, 2>(g, vol, ue, fe, lam, mu, E, s); break;
      case 3: launch<2, 3, 1, 3>(g, vol, ue, fe, lam, mu, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
