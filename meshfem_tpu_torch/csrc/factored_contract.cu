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
// Layout (kernel C's): g [K1 * d, E] (row k * d + b), vol [E],
// ue [d, n, E] -> fe [d, n, E]; element index fastest.
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
//   element at all (one per block, after the tables are built).  A block
//   walks many groups of 256 elements, so the table build is paid once.
// To keep the live values of one element near 100 registers, the S product
// runs first (d1, A and g live), f = g . A follows, and u is read again
// from memory (an L1 or L2 hit) for the W phase (u, f and G2 live).
// Global loads and stores are coalesced (256 consecutive elements per
// block).  The shared-memory pipe is the likely bound: each broadcast
// 16-byte load of S or W still returns 16 bytes to every lane, ~385 of them
// per 32 elements.  Two elements a thread, which halves those loads, ran
// slower on an H100: its registers left one block an SM.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

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
};

// index of block (rb, sb), rb <= sb, in the order rb-major
template <int RB>
__host__ __device__ constexpr int block_index(int rb, int sb) {
  return rb * RB - rb * (rb - 1) / 2 + (sb - rb);
}

template <int DIM, int NN>
__global__ void __launch_bounds__(kThreads, 2)
factored_contract_kernel(const float* __restrict__ g,
                         const float* __restrict__ vol,
                         const float* __restrict__ ue,
                         const float* __restrict__ T_g,
                         float* __restrict__ fe, float lam, float mu,
                         int64_t E) {
  using Sh = Shape<DIM, NN>;
  constexpr int K1 = Sh::K1, R = Sh::R, RB = Sh::RB;
  constexpr int NG = Sh::NG, NGP = Sh::NGP;
  __shared__ __align__(16) float sS[Sh::NBLK * 16];
  __shared__ __align__(16) float sW[Sh::NPAIR * NGP];

  // S in 4 x 4 blocks (rb <= sb), each row-major, zero past R
  for (int idx = threadIdx.x; idx < Sh::NBLK * 16; idx += kThreads) {
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
  for (int idx = threadIdx.x; idx < Sh::NPAIR * NGP; idx += kThreads) {
    int p = idx / NGP, q = idx % NGP;
    float v = 0.0f;
    if (q < NG) {
      int i = 0, k = 0;
      while (p >= NN - i) { p -= NN - i; ++i; }
      while (q >= K1 - k) { q -= K1 - k; ++k; }
      const int j = i + p, m = k + q;
      v = __ldg(T_g + ((k * K1 + m) * NN + i) * NN + j);
      if (k != m) v += __ldg(T_g + ((m * K1 + k) * NN + i) * NN + j);
      v *= mu;
    }
    sW[idx] = v;
  }
  __syncthreads();

  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < E; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    float gk[K1][DIM];
#pragma unroll
    for (int k = 0; k < K1; ++k)
#pragma unroll
      for (int c = 0; c < DIM; ++c) gk[k][c] = __ldg(g + (k * DIM + c) * E + e);

    // d1[(l, j)] = sum_c g[l, c] u[c, j]
    float d1[RB * 4];
    {
      float u[DIM][NN];
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int j = 0; j < NN; ++j) u[c][j] = __ldg(ue + (c * NN + j) * E + e);
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
        for (int j = 0; j < NN; ++j) u[c][j] = __ldg(ue + (c * NN + j) * E + e);
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

    const float v = __ldg(vol + e);
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int i = 0; i < NN; ++i) fe[(c * NN + i) * E + e] = v * f[c][i];
  }
}

template <int DIM, int NN>
int launch(const void* g, const void* vol, const void* ue, const void* T,
           void* fe, float lam, float mu, int64_t E, cudaStream_t stream) {
  auto kernel = factored_contract_kernel<DIM, NN>;
  // blocks resident at once on each device, worked out at the first launch
  // there; 0 = not yet
  static std::atomic<int> resident_on[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int resident = resident_on[dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    resident_on[dev].store(resident, std::memory_order_relaxed);
  }
  const int64_t groups = (E + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(groups < resident ? groups : resident);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(vol),
      static_cast<const float*>(ue), static_cast<const float*>(T),
      static_cast<float*>(fe), lam, mu, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  T is the
// gradgrad table [K1, K1, n, n] float32, row-major, in device memory.
extern "C" int factored_contract_f32(int cfg, const void* g, const void* vol,
                                     const void* ue, const void* T, void* fe,
                                     float lam, float mu, int64_t E,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  switch (cfg) {
    case 0: return launch<3, 10>(g, vol, ue, T, fe, lam, mu, E, s);
    case 1: return launch<3, 4>(g, vol, ue, T, fe, lam, mu, E, s);
    case 2: return launch<2, 6>(g, vol, ue, T, fe, lam, mu, E, s);
    case 3: return launch<2, 3>(g, vol, ue, T, fe, lam, mu, E, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
