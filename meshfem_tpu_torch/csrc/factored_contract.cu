// Kernel D: factored_contract — the isotropic element apply
//
//   fe[c, i, e] = (vol_e Ke_e u_e)[c, i]
//
// through the gradgrad table T[k, l, i, j] = int (dphi_i/dlam_k)
// (dphi_j/dlam_l), from grad_lambda and the volume alone.  The TPU kernel's
// table form is
//
//   d1[k, j]   = sum_c g[k, c] u[c, j]
//   m1[k, i]   = sum_{l, j} T[k, l, i, j] d1[l, j]
//   m2[l, i]   = sum_{k, j} T[k, l, i, j] d1[k, j]
//   q_c[km, i] = sum_j T[k, m, i, j] u[c, j],        G2[km] = g_k . g_m
//   f[c, i]    = vol (mu sum_km G2[km] q_c[km, i]
//                     + sum_k g[k, c] (lam m1[k, i] + mu m2[k, i]))
//
// Replaces meshfem_tpu/sparse/contract.py::_factored_kernel (:91), the
// TQ-table backend of the routed operator (routed_ebe.py:720-731).  The TPU
// kernel pads n to the sublane tile, re-blocks T into three matrices (TM1,
// TM2, TQ) for its matrix unit and bakes lam and mu into the compiled
// kernel; here lam and mu are arguments and the kernel builds its own two
// tables from T, once per block, in shared memory.
//
// Layout (kernel C's, csrc/qp_contract.cu): g [K1 * d, E] (row k * d + b)
// and vol [E], element index fastest; u and f through four shared strides
// (element, node, component, column) and m columns, one thread per
// (element, column): planes [d, n, E] (m = 1) read and written in place,
// element-major node rows [E, n, d m] (slot e n + a, value c m + j) staged
// through shared memory by each warp, floor(32 / m) elements at a time
// (csrc/stage_rows.cuh; the reason, and why a thread does not loop over the
// columns, are kernel C's).  Both layouts run the same per-element
// arithmetic (factored_element), so they give the same bits.
//
// Bound on the H100: memory, as for kernel C, which computes the same
// function of the same inputs: 73 floats per element move (~22 us for the
// 248,220 elements of the periodic cell at 3.35 TB/s).
//
// Route: FP32 FMA on the CUDA cores, not 3xTF32 tensor cores.  After the
// two reassociations below the element needs ~2.7k multiply-adds
// (d = 3, P2), ~20 us for the cell at the 67 TFLOP/s float32 rate, under
// the byte bound; the tensor cores would turn the per-element vectors into
// mma fragments spread over lanes and need shuffles for the sums over k,
// for no gain in a kernel the bytes bound.  Both reassociations compute the
// same function as the TPU kernel, in another float32 order:
//
//   S[(k,i),(l,j)] = lam T[k,l,i,j] + mu T[l,k,i,j]   so lam m1 + mu m2 = S d1
//   W[i, j]        = mu sum_km G2[km] T[k,m,i,j]     so mu sum_km G2 q_c = W u_c
//
// S (40 x 40 at d = 3, P2) is symmetric, because T[k,l,i,j] = T[l,k,j,i],
// and so is W, because G2 is too.  One product with S (1,600 multiply-adds)
// replaces m1 and m2 (3,200); W from the 10 distinct G2 and its 55 distinct
// entries (550) and W u (300) replace the 4,800 of the q phase.
//
// What held the first Hopper version back, and what this design does about
// it:
// * it did ~8.9k multiply-adds per element, each table value read from
//   shared memory feeding two: the two reassociations cut the work to
//   ~2.7k, and only the distinct entries of S (its 4 x 4 blocks on and above
//   the diagonal, 55 blocks) and of W are stored, so one warp-wide
//   broadcast 16-byte load of S feeds 32 multiply-adds a lane off the
//   diagonal (both A[r] += S[r,s] d1[s] and A[s] += S[r,s] d1[r]);
// * four warps shared 32 elements through shared memory with four
//   __syncthreads per group of 32 and unequal shares (8/8/7/7 of 30
//   outputs): now one thread owns one element from load to store, with
//   d1, A = S d1, f and the G2 in registers, so there is no barrier per
//   element (one per block, after the tables are built; in rows a warp's
//   three __syncwarp a group, around its staging).  A block walks many
//   groups of elements, so the table build is paid once.
// To keep the live values of one element near 100 registers, the S product
// runs first (d1, A and g live), f = g . A follows, and u is read again
// (an L1 or L2 hit in planes, the staged row in rows) for the W phase (u,
// f and G2 live).
// Global loads and stores are coalesced (consecutive elements on
// consecutive lanes in planes, whole staged stretches in rows).  The shared-memory pipe is the likely bound: each broadcast
// 16-byte load of S or W still returns 16 bytes to every lane, ~385 of them
// per 32 elements.  Two elements a thread, which halves those loads, ran
// slower on an H100: its registers left one block an SM.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <int DIM, int NN>
struct Shape {
  static constexpr int K1 = DIM + 1;
  static constexpr int R = K1 * NN;                  // rows (k, i) of S
  static constexpr int RB = (R + 3) / 4;             // 4 x 4 blocks a side
  static constexpr int NBLK = RB * (RB + 1) / 2;     // blocks rb <= sb
  static constexpr int NG = K1 * (K1 + 1) / 2;       // G2[k, m], k <= m
  static constexpr int NGP = (NG + 3) / 4 * 4;
  static constexpr int NPAIR = NN * (NN + 1) / 2;    // W[i, j], i <= j
  static constexpr int kTableBytes = (NBLK * 16 + NPAIR * NGP) * 4;
};

// index of block (rb, sb), rb <= sb, in the order rb-major
template <int RB>
__host__ __device__ constexpr int block_index(int rb, int sb) {
  return rb * RB - rb * (rb - 1) / 2 + (sb - rb);
}

struct Strides {
  int64_t e, a, c, j;  // element, node, component, column
};

// One element and one column: u[c][j] = ld(c, j) (read twice), the forces
// st(c, i, vol f[c][i]).
template <int DIM, int NN, class Load, class Store>
__device__ __forceinline__ void factored_element(
    const float* sS, const float* sW, const float (&gk)[DIM + 1][DIM],
    float v, Load ld, Store st) {
  using Sh = Shape<DIM, NN>;
  constexpr int K1 = Sh::K1, R = Sh::R, RB = Sh::RB;
  constexpr int NG = Sh::NG, NGP = Sh::NGP;

  // d1[(l, j)] = sum_c g[l, c] u[c, j]
  float d1[RB * 4];
  {
    float u[DIM][NN];
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int j = 0; j < NN; ++j) u[c][j] = ld(c, j);
#pragma unroll
    for (int r = 0; r < RB * 4; ++r) {
      float acc = 0.0f;
      if (r < R) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) acc += gk[r / NN][c] * u[c][r % NN];
      }
      d1[r] = acc;
    }
  }

  // A = S d1 over the stored blocks; an off-diagonal block serves both
  // A[r] (row r of S) and A[s] (row s, by symmetry)
  float A[RB * 4];
#pragma unroll
  for (int r = 0; r < RB * 4; ++r) A[r] = 0.0f;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
#pragma unroll
    for (int sb = rb; sb < RB; ++sb) {
      const float4* blk = reinterpret_cast<const float4*>(sS)
                          + block_index<RB>(rb, sb) * 4;
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const float4 t4 = blk[r4];
        const float t[4] = {t4.x, t4.y, t4.z, t4.w};
        const int r = rb * 4 + r4;
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int s = sb * 4 + s4;
          if (r < R && s < R) {
            A[r] += t[s4] * d1[s];
            if (sb != rb) A[s] += t[s4] * d1[r];
          }
        }
      }
    }
  }

  // f[c, i] = sum_k g[k, c] A[(k, i)]
  float f[DIM][NN];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K1; ++k) acc += gk[k][c] * A[k * NN + i];
      f[c][i] = acc;
    }

  // G2[k, m] = g_k . g_m for k <= m
  float G2[NGP];
  {
    int q = 0;
#pragma unroll
    for (int k = 0; k < K1; ++k)
#pragma unroll
      for (int m = k; m < K1; ++m, ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) acc += gk[k][c] * gk[m][c];
        G2[q] = acc;
      }
#pragma unroll
    for (int r = NG; r < NGP; ++r) G2[r] = 0.0f;
  }

  // f[c, i] += sum_j W[i, j] u[c, j], one distinct W[i, j] at a time
  {
    float u[DIM][NN];
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int j = 0; j < NN; ++j) u[c][j] = ld(c, j);
    int p = 0;
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = i; j < NN; ++j, ++p) {
        const float4* row = reinterpret_cast<const float4*>(sW + p * NGP);
        float w = 0.0f;
#pragma unroll
        for (int q4 = 0; q4 < NGP / 4; ++q4) {
          const float4 t4 = row[q4];
          const float t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (q4 * 4 + s < NG) w += t[s] * G2[q4 * 4 + s];
        }
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          f[c][i] += w * u[c][j];
          if (j != i) f[c][j] += w * u[c][i];
        }
      }
  }

#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int i = 0; i < NN; ++i) st(c, i, v * f[c][i]);
}

// M >= 0: element-major node rows, each warp staging a group of its own
// elements in shared memory at a time, one lane per (element, column) of
// the group, with M <= 32 columns (0: m at run time; kernel C says why a
// compile-time M); M = -1: one thread per (element, column) item reads and
// writes where the strides put the values.  Either way a block walks many
// groups, so the table build is paid once a block.
template <int DIM, int NN, int M>
__global__ void __launch_bounds__(kThreads, 2)
factored_contract_kernel(const float* __restrict__ g,
                         const float* __restrict__ vol,
                         const float* __restrict__ ue,
                         const float* __restrict__ T_g,
                         float* __restrict__ fe, float lam, float mu,
                         int64_t E, int m_rt, Strides st) {
  constexpr bool ROWS = M >= 0;
  const int m = M > 0 ? M : m_rt;
  using Sh = Shape<DIM, NN>;
  constexpr int K1 = Sh::K1, R = Sh::R, RB = Sh::RB;
  constexpr int NG = Sh::NG, NGP = Sh::NGP;
  __shared__ __align__(16) float sS[Sh::NBLK * 16];
  __shared__ __align__(16) float sW[Sh::NPAIR * NGP];
  extern __shared__ __align__(16) float s_rows[];

  // S in 4 x 4 blocks (rb <= sb), each row-major, zero past R
  for (int idx = threadIdx.x; idx < Sh::NBLK * 16; idx += blockDim.x) {
    int b = idx / 16, rb = 0;
    while (b >= RB - rb) { b -= RB - rb; ++rb; }
    const int r = rb * 4 + (idx % 16) / 4, s = (rb + b) * 4 + idx % 4;
    float v = 0.0f;
    if (r < R && s < R) {
      const int k = r / NN, i = r % NN, l = s / NN, j = s % NN;
      v = lam * __ldg(T_g + ((k * K1 + l) * NN + i) * NN + j)
          + mu * __ldg(T_g + ((l * K1 + k) * NN + i) * NN + j);
    }
    sS[idx] = v;
  }
  // W's coefficients: row (i <= j), column (k <= m), zero past NG
  for (int idx = threadIdx.x; idx < Sh::NPAIR * NGP; idx += blockDim.x) {
    int p = idx / NGP, q = idx % NGP;
    float v = 0.0f;
    if (q < NG) {
      int i = 0, k = 0;
      while (p >= NN - i) { p -= NN - i; ++i; }
      while (q >= K1 - k) { q -= K1 - k; ++k; }
      const int j = i + p, m2 = k + q;
      v = __ldg(T_g + ((k * K1 + m2) * NN + i) * NN + j);
      if (k != m2) v += __ldg(T_g + ((m2 * K1 + k) * NN + i) * NN + j);
      v *= mu;
    }
    sW[idx] = v;
  }
  __syncthreads();

  if constexpr (ROWS) {
    // each warp walks its own groups of elements_per_warp(m) elements
    const int P = DIM * NN * m, Pp = stage_rows::padded(P, m);
    const int per_warp = stage_rows::elements_per_warp(m);
    const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
    float* rows = s_rows + (threadIdx.x / 32) * per_warp * Pp;
    const int q = lane / m, j = lane - q * m;
    for (int64_t e0 = (static_cast<int64_t>(blockIdx.x) * warps
                       + threadIdx.x / 32) * per_warp;
         e0 < E; e0 += static_cast<int64_t>(gridDim.x) * warps * per_warp) {
      const int ne = static_cast<int>(E - e0 < per_warp ? E - e0 : per_warp);
      stage_rows::copy_in(rows, ue + e0 * P, ne * P, P, Pp, lane);
      __syncwarp();
      if (q < ne) {
        const int64_t e = e0 + q;
        float gk[K1][DIM];
#pragma unroll
        for (int k = 0; k < K1; ++k)
#pragma unroll
          for (int c = 0; c < DIM; ++c)
            gk[k][c] = __ldg(g + (k * DIM + c) * E + e);
        const float v = __ldg(vol + e);
        float* col = rows + q * Pp + j;
        factored_element<DIM, NN>(
            sS, sW, gk, v,
            [&](int c, int a) { return col[(a * DIM + c) * m]; },
            [&](int c, int a, float x) { col[(a * DIM + c) * m] = x; });
      }
      __syncwarp();
      stage_rows::copy_out(fe + e0 * P, rows, ne * P, P, Pp, lane);
      __syncwarp();
    }
  } else {
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
         t < E * m; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      const int64_t j = m == 1 ? 0 : t / E, e = t - j * E;
      float gk[K1][DIM];
#pragma unroll
      for (int k = 0; k < K1; ++k)
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          gk[k][c] = __ldg(g + (k * DIM + c) * E + e);
      const float v = __ldg(vol + e);
      const float* u_e = ue + e * st.e + j * st.j;
      float* f_e = fe + e * st.e + j * st.j;
      factored_element<DIM, NN>(
          sS, sW, gk, v,
          [&](int c, int a) { return __ldg(u_e + a * st.a + c * st.c); },
          [&](int c, int a, float x) { f_e[a * st.a + c * st.c] = x; });
    }
  }
}

template <int DIM, int NN>
int launch(const void* g, const void* vol, const void* ue, const void* T,
           void* fe, float lam, float mu, int64_t E, int m, Strides s,
           cudaStream_t stream) {
  const int P = DIM * NN * m;
  // element-major rows with at most 32 columns stage; any other strides,
  // rows with more columns too, take the direct path
  const bool rows = s.e == P && s.a == DIM * m && s.c == m && s.j == 1
                    && m <= 32;
  auto kernel = !rows ? factored_contract_kernel<DIM, NN, -1>
                : m == 1 ? factored_contract_kernel<DIM, NN, 1>
                : m == 3 ? factored_contract_kernel<DIM, NN, 3>
                : m == 6 ? factored_contract_kernel<DIM, NN, 6>
                         : factored_contract_kernel<DIM, NN, 0>;
  // a block holds kThreads / 32 warps; a group is a warp's elements in
  // rows, a block's (element, column) items otherwise
  int smem = 0;
  int64_t per_group = kThreads;
  if (rows) {
    per_group = stage_rows::elements_per_warp(m);
    smem = (kThreads / 32) * per_group * stage_rows::padded(P, m)
           * static_cast<int>(sizeof(float));
    if (smem + Shape<DIM, NN>::kTableBytes > 48 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = kThreads;
  // blocks resident at once on each device, for each layout and column
  // count, worked out at the first launch there (0 = not yet)
  static std::atomic<int64_t> resident_on[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t key = rows ? m : 0;
  const int64_t cached = resident_on[dev][rows].load(std::memory_order_relaxed);
  int resident = (cached >> 32) == key ? static_cast<int>(cached & 0xffffffff)
                                       : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    resident_on[dev][rows].store((key << 32) | resident,
                                 std::memory_order_relaxed);
  }
  const int64_t groups = rows
      ? (E + per_group * (kThreads / 32) - 1) / (per_group * (kThreads / 32))
      : (E * m + per_group - 1) / per_group;
  const unsigned blocks =
      static_cast<unsigned>(groups < resident ? groups : resident);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(vol),
      static_cast<const float*>(ue), static_cast<const float*>(T),
      static_cast<float*>(fe), lam, mu, E, m, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  T is the
// gradgrad table [K1, K1, n, n] float32, row-major, in device memory.  ue
// and fe share the strides (s_e, s_a, s_c, s_j) and m columns;
// element-major rows (s_e = n d m, s_a = d m, s_c = m, s_j = 1) take the
// staged kernel.
extern "C" int factored_contract_f32(int cfg, const void* g, const void* vol,
                                     const void* ue, const void* T, void* fe,
                                     float lam, float mu, int64_t E, int m,
                                     int64_t s_e, int64_t s_a, int64_t s_c,
                                     int64_t s_j, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{s_e, s_a, s_c, s_j};
  if (E <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  switch (cfg) {
    case 0: return launch<3, 10>(g, vol, ue, T, fe, lam, mu, E, m, s, st);
    case 1: return launch<3, 4>(g, vol, ue, T, fe, lam, mu, E, m, s, st);
    case 2: return launch<2, 6>(g, vol, ue, T, fe, lam, mu, E, m, s, st);
    case 3: return launch<2, 3>(g, vol, ue, T, fe, lam, mu, E, m, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
