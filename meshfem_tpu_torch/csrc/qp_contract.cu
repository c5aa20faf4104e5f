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
// element and column, keeps its u [d, n] and f [d, n] in registers, and
// takes lam and mu as arguments.
//
// Layout: g [K1 * d, E] (row k * d + b) and vol [E], element index fastest,
// so a warp's loads of them are coalesced.  The element values u and the
// forces f share one layout, given by four strides (element, node,
// component, column) and a column count m:
//   u(e, i, c, j) = ue[e * s_e + i * s_a + c * s_c + j * s_j]
// and one thread computes one (element, column).  Two layouts run on the
// card (any other strides take the direct path of the planes):
//   - planes [d, n, E] (s_e = 1, s_a = E, s_c = n E, m = 1): read and
//     written in place, coalesced, as the first version of this kernel did;
//   - element-major node rows [E, n, d m] (slot e n + a, value c m + j;
//     s_e = n d m, s_a = d m, s_c = m, s_j = 1): kernels A and B's rows
//     layout, which the routed operator runs in, all m columns of a block
//     apply in one launch.  An element's values are then one stretch of
//     n d m floats (120 B at d = 3, P2, m = 1; 720 B at m = 6), so direct
//     loads would put a warp's 32 lanes in up to 32 sectors.  But the rows
//     of a warp's elements are ONE contiguous stretch, so the warp stages
//     them in its part of shared memory (csrc/stage_rows.cuh: coalesced
//     4-byte cp.async in, every load in flight before the wait; rows padded
//     so that the lanes' reads fall in distinct banks), its m lanes an
//     element each compute one column and write the forces over the values
//     they have read, and the warp writes the stretch back with coalesced
//     streaming stores.  A warp stages floor(32 / m) elements (5 at m = 6),
//     with __syncwarp and no block barrier, so the warps of an SM overlap
//     their waits as in planes; a block of 4 warps takes 15.8-16.9 KB of
//     shared memory at d = 3, P2.  The column count is a template constant
//     for m = 1, 3 and 6 (the paths' counts), so every offset into the
//     staged row is an immediate; other m up to 32 take an instance with m
//     at run time, and more columns the direct path below.
// A thread that looped over the m columns, loading g and vol once, was
// tried first on an H100: the compiler hoisted the column-invariant shape
// gradients of every quadrature point out of the loop, nearly every
// register went to them, and the kernel ran slower than in planes even at
// m = 1 (kernel D, whose S and W table loads it hoisted as well, spilled
// to the stack and ran many times slower).  One thread per (element,
// column) keeps the first version's register plan; an element's m threads
// read its g and vol together (one sector).
// Both layouts run the same per-element arithmetic (qp_element), so the
// two give the same bits.  dN [Q, n, K1] and W [Q] live in __constant__
// memory, one table per (dim, deg) configuration, uploaded once per device
// by qp_set_tables.
//
// Bound on the H100: memory.  4 (K1 d + 1 + 2 n d m) bytes per element
// move (12 g + 1 vol + 30 u in, 30 f out at d = 3, P2, m = 1): 82 MB at the
// bench size, ~24 us at 3.35 TB/s; at m = 6 on the periodic cell 373 floats
// an element, 0.11 ms.  The arithmetic (~2.5 kFLOP per element and column
// at dim 3 / deg 2) is ~10 us a column at the 67 TFLOP/s f32 peak.  Every
// loop over the element is unrolled at compile time so the per-element
// state stays in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kMaxQ = 4;
constexpr int kMaxN = 10;
constexpr int kMaxK1 = 4;
constexpr int kNumCfg = 4;  // (dim, deg) = (3, 2), (3, 1), (2, 2), (2, 1)
constexpr int kTab = kMaxQ * kMaxN * kMaxK1;
constexpr int kThreads = 128;

__constant__ float c_dN[kNumCfg * kTab];
__constant__ float c_W[kNumCfg * kMaxQ];

// One element and one column: u[c][i] = ld(c, i) in, st(c, i, f[c][i]) out.
template <int DIM, int NN, int Q, int CFG, class Load, class Store>
__device__ __forceinline__ void qp_element(const float (&gl)[DIM + 1][DIM],
                                           float v, float lam, float mu,
                                           Load ld, Store st) {
  constexpr int K1 = DIM + 1;
  float u[DIM][NN];
  float f[DIM][NN];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      u[c][i] = ld(c, i);
      f[c][i] = 0.0f;
    }

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
    for (int i = 0; i < NN; ++i) st(c, i, f[c][i]);
}

struct Strides {
  int64_t e, a, c, j;  // element, node, component, column
};

// M >= 0: element-major node rows, each warp staging its own elements in
// shared memory, one lane per (element, column) of them, with M <= 32
// columns (0: m at run time; a compile-time M makes every offset into the
// staged row an immediate, which the in-place stores would otherwise hold
// in registers); M = -1: one thread per (element, column) reads and writes
// where the strides put the values.
template <int DIM, int NN, int Q, int CFG, int M>
__global__ void qp_contract_kernel(const float* __restrict__ g,
                                   const float* __restrict__ vol,
                                   const float* __restrict__ ue,
                                   float* __restrict__ fe, float lam, float mu,
                                   int64_t E, int m_rt, Strides s) {
  constexpr int K1 = DIM + 1;
  constexpr bool ROWS = M >= 0;
  const int m = M > 0 ? M : m_rt;
  extern __shared__ __align__(16) float s_rows[];
  int64_t e, j, e0 = 0;
  int P = 0, Pp = 0, ne = 0, q = 0;
  const int lane = threadIdx.x % 32;
  float* rows = s_rows;
  if constexpr (ROWS) {
    const int per_warp = stage_rows::elements_per_warp(m);
    e0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32)
          + threadIdx.x / 32) * per_warp;
    P = DIM * NN * m;
    Pp = stage_rows::padded(P, m);
    rows += (threadIdx.x / 32) * per_warp * Pp;
    ne = static_cast<int>(E - e0 < per_warp ? (E > e0 ? E - e0 : 0)
                                             : per_warp);
    stage_rows::copy_in(rows, ue + e0 * P, ne * P, P, Pp, lane);
    __syncwarp();
    q = lane / m;
    j = lane - q * m;
    e = q < ne ? e0 + q : E;
  } else {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    j = m == 1 ? 0 : t / E;
    e = j < m ? t - j * E : E;
  }
  if (e < E) {
    float gl[K1][DIM];
#pragma unroll
    for (int k = 0; k < K1; ++k)
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        gl[k][b] = __ldg(g + (k * DIM + b) * E + e);
    const float v = __ldg(vol + e);
    if constexpr (ROWS) {
      float* col = rows + q * Pp + j;
      qp_element<DIM, NN, Q, CFG>(
          gl, v, lam, mu,
          [&](int c, int i) { return col[(i * DIM + c) * m]; },
          [&](int c, int i, float x) { col[(i * DIM + c) * m] = x; });
    } else {
      const float* u_e = ue + e * s.e + j * s.j;
      float* f_e = fe + e * s.e + j * s.j;
      qp_element<DIM, NN, Q, CFG>(
          gl, v, lam, mu,
          [&](int c, int i) { return __ldg(u_e + i * s.a + c * s.c); },
          [&](int c, int i, float x) { f_e[i * s.a + c * s.c] = x; });
    }
  }
  if constexpr (ROWS) {
    __syncwarp();
    stage_rows::copy_out(fe + e0 * P, rows, ne * P, P, Pp, lane);
  }
}

template <int DIM, int NN, int Q, int CFG>
int launch(const void* g, const void* vol, const void* ue, void* fe,
           float lam, float mu, int64_t E, int m, Strides s,
           cudaStream_t stream) {
  const int P = DIM * NN * m;
  // element-major rows with at most 32 columns stage; any other strides,
  // rows with more columns too, take the direct path
  const bool rows = s.e == P && s.a == DIM * m && s.c == m && s.j == 1
                    && m <= 32;
  auto kernel = !rows ? qp_contract_kernel<DIM, NN, Q, CFG, -1>
                : m == 1 ? qp_contract_kernel<DIM, NN, Q, CFG, 1>
                : m == 3 ? qp_contract_kernel<DIM, NN, Q, CFG, 3>
                : m == 6 ? qp_contract_kernel<DIM, NN, Q, CFG, 6>
                         : qp_contract_kernel<DIM, NN, Q, CFG, 0>;
  const int threads = kThreads;
  int smem = 0;
  int64_t blocks = (E * m + threads - 1) / threads;
  if (rows) {
    const int per_block = (threads / 32) * stage_rows::elements_per_warp(m);
    smem = per_block * stage_rows::padded(P, m)
           * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    blocks = (E + per_block - 1) / per_block;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(vol),
      static_cast<const float*>(ue), static_cast<float*>(fe), lam, mu, E, m,
      s);
  return static_cast<int>(cudaGetLastError());
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

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  ue and fe
// share the strides (s_e, s_a, s_c, s_j) and m columns; element-major rows
// (s_e = n d m, s_a = d m, s_c = m, s_j = 1) take the staged kernel.
extern "C" int qp_contract_f32(int cfg, const void* g, const void* vol,
                               const void* ue, void* fe, float lam, float mu,
                               int64_t E, int m, int64_t s_e, int64_t s_a,
                               int64_t s_c, int64_t s_j, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{s_e, s_a, s_c, s_j};
  if (E <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  switch (cfg) {
    case 0: return launch<3, 10, 4, 0>(g, vol, ue, fe, lam, mu, E, m, s, st);
    case 1: return launch<3, 4, 1, 1>(g, vol, ue, fe, lam, mu, E, m, s, st);
    case 2: return launch<2, 6, 3, 2>(g, vol, ue, fe, lam, mu, E, m, s, st);
    case 3: return launch<2, 3, 1, 3>(g, vol, ue, fe, lam, mu, E, m, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
