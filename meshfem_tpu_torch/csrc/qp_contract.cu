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
// bakes its tables, lam and mu into the compiled kernel; here one thread
// owns one element and column, keeps its u [d, n] and f [d, n] in
// registers, and takes lam and mu as arguments.
//
// Tables: dN [Q, n, K1] and W [Q] of the four configurations are compiled
// in (csrc/qp_tables.cuh, written by kernels/qp.py::table_header from
// sparse.contract.qp_tables, exact float32 hex literals).  Every index into
// them is a compile-time constant once the loops are unrolled, so the
// values become immediates and a zero entry's term is skipped: 112 of the
// 160 dN entries are nonzero at d = 3, P2, and at P1 dN is the identity,
// so gphi is g itself.  Skipping a term 0 * g of a sum leaves the sum's
// bits unchanged (for finite g), and the sums keep their order, so the
// forces are those of the full sums.
//
// Layout: g [K1 * d, E] (row k * d + b) and vol [E], element index fastest.
// The element values u and the forces f share one layout, given by four
// strides (element, node, component, column) and a column count m:
//   u(e, i, c, j) = ue[e * s_e + i * s_a + c * s_c + j * s_j]
// Two layouts run on the card:
//   - planes [d, n, E] (s_e = 1, s_a = E, s_c = n E, m = 1), and any other
//     strides: the direct path, one thread per (element, column) reading
//     and writing in place (coalesced in planes);
//   - element-major node rows [E, n, d m] (slot e n + a, value c m + j;
//     s_e = n d m, s_a = d m, s_c = m, s_j = 1), kernels A and B's rows
//     layout, in which the routed operator runs, all m columns of a block
//     apply in one launch: the pipelined path below.
//
// The pipelined rows path.  An element's values are one stretch of
// P = n d m floats (120 B at d = 3, P2, m = 1; 720 B at m = 6), and a tile
// of te consecutive elements is ONE stretch of te P floats, so a single
// bulk asynchronous copy (cp.async.bulk, csrc/bulk_async.cuh) moves it.
// One lane computes one element and CPT of its columns (CPT = 2 at m = 6,
// else 1), so te = floor(32 CPT / m), rounded down so that te P floats are
// whole 16-byte units (32 at m = 1, 10 at m = 6: 3.8 KB and 7.2 KB at
// d = 3, P2).  The grid is persistent: as many blocks of 4 warps
// as the SMs hold at once, and each warp walks the tiles w, w + W, ...
// (W warps in all) through a ring of 3 stages in its part of shared
// memory.  While the warp computes tile k from its stage, tile k + 1's rows
// are in flight to the next stage (one bulk copy, completing an mbarrier)
// and tile k - 1's forces drain from the stage before (one bulk store);
// the lanes copy each tile's g and vol alongside (4-byte cp.async, one
// element a lane, coalesced).  The lanes compute with the rows in shared
// memory, write the forces over the values they read, and the warp's lane
// 0 stores the stretch back once a fence orders those writes before the
// copy engine reads them.  Before a stage is refilled, lane 0 waits until
// the store issued from it has read it.  No block barrier: each warp runs
// its own ring, so the warps of an SM overlap one another's waits too.
// The last tile of the grid may be partial, and its stretch a length that
// is no whole number of 16-byte units (333 elements at d = 2, P1, m = 1:
// 333 x 24 B); the warp that owns it copies it in and out with 4-byte
// loads and streaming stores.  Rows are not padded: at P = 30 floats lanes
// t and t + 16 read the same bank, a 2-way conflict on the 60 shared-
// memory accesses beside the ~1,000 arithmetic instructions of an element
// and column, where padding would break the stretch's 16-byte units and
// with them the bulk copy.  Odd m above 16, a
// stretch or pointer not 16-byte aligned, and m > 32 take the direct path.
// The column count is a template constant for m = 1, 3 and 6 (the paths'
// counts), so every offset into the staged row is an immediate.
// Columns a lane: a lane that loops over all m columns outside the
// quadrature loop lets the compiler hoist the shape gradients of every
// quadrature point out of the column loop and run out of registers.  Here
// the quadrature loop is outside: a point's gradients are computed once
// and the lane's CPT columns use them in turn, each column's sums exactly
// those of a lane with one column.  At m = 6 two columns a lane halve the
// gradients' multiply-adds (217 registers, no spill, two blocks an SM
// against three); on the H100 that ran no slower than one column a lane,
// and no faster by much, since the bytes bound the kernel at m = 6.  An
// element's lanes read its g and vol together (one broadcast).
// Both layouts run the same per-element arithmetic (qp_element), so the
// two give the same bits.
//
// Bound on the H100: memory.  4 (K1 d + 1 + 2 n d m) bytes per element
// move (12 g + 1 vol + 30 u in, 30 f out at d = 3, P2, m = 1): 82 MB at the
// bench size, ~24 us at 3.35 TB/s; at m = 6 on the periodic cell 373 floats
// an element, 0.11 ms.  The arithmetic (~2.6 kFLOP per element and column
// at dim 3 / deg 2) is ~11 us a column at the 67 TFLOP/s f32 peak: under
// the bytes, but not by much, so the copies must overlap it.  Every loop
// over the element is unrolled at compile time so the per-element state
// stays in registers: at d = 3, P2 168 registers a thread with one column
// a lane (__launch_bounds__ for three blocks, 12 warps, an SM) and 217
// with two (two blocks), no spill; each warp keeps its next tile and its
// g and vol (5.5 KB at m = 1, 7.7 KB at m = 6) in flight, ~60-66 KB an SM.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, L2 flushed
// before each launch): in rows 0.0363 ms at m = 1 on the 279,936-element
// bench mesh (bound 0.0244) and 0.1378 ms at m = 6 on the 248,220-element
// periodic cell (bound 0.1106); in planes 0.0387.  The timer's flush
// leaves the L2 dirty, and each launch pays for writing those lines back;
// chip_smoke.py's clean_l2_ms times the kernel with the L2 flushed by a
// read instead.

#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bulk_async.cuh"
#include "qp_tables.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;  // warps a block, each its own ring
constexpr int kStages = 3;             // tiles a warp holds in shared memory
constexpr int kMaxDevices = 64;

// One element and CPT of its columns: u[cc][c][i] = ld(cc, c, i) in,
// st(cc, c, i, f[cc][c][i]) out.  The shape gradients of a quadrature
// point are computed once for the CPT columns; each column's sums are
// those of one column alone, in the same order.
template <int DIM, int NN, int Q, int CFG, int CPT, class Load, class Store>
__device__ __forceinline__ void qp_element(const float (&gl)[DIM + 1][DIM],
                                           float v, float lam, float mu,
                                           Load ld, Store st) {
  using Tab = qp_tables::Table<CFG>;
  static_assert(Tab::kDim == DIM && Tab::kNodes == NN && Tab::kQ == Q,
                "qp_tables.cuh does not match the configuration");
  constexpr int K1 = DIM + 1;
  float u[CPT][DIM][NN];
  float f[CPT][DIM][NN];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int i = 0; i < NN; ++i) {
        u[cc][c][i] = ld(cc, c, i);
        f[cc][c][i] = 0.0f;
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
        for (int k = 0; k < K1; ++k) {
          const float w = Tab::dN((q * NN + i) * K1 + k);
          if (w != 0.0f) acc += w * gl[k][b];
        }
        gphi[i][b] = acc;
      }
    const float wv = v * Tab::W(q);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      float G[DIM][DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int b = 0; b < DIM; ++b) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < NN; ++i) acc += u[cc][c][i] * gphi[i][b];
          G[c][b] = acc;
        }
      float tr = 0.0f;
#pragma unroll
      for (int c = 0; c < DIM; ++c) tr += G[c][c];
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
          for (int c = 0; c < DIM; ++c) f[cc][c][i] += gphi[i][b] * S[c][b];
    }
  }

#pragma unroll
  for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int i = 0; i < NN; ++i) st(cc, c, i, f[cc][c][i]);
}

struct Strides {
  int64_t e, a, c, j;  // element, node, component, column
};

// The direct path: one thread per (element, column) reads and writes where
// the strides put the values.
template <int DIM, int NN, int Q, int CFG>
__global__ void qp_direct_kernel(const float* __restrict__ g,
                                 const float* __restrict__ vol,
                                 const float* __restrict__ ue,
                                 float* __restrict__ fe, float lam, float mu,
                                 int64_t E, int m, Strides s) {
  constexpr int K1 = DIM + 1;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t j = m == 1 ? 0 : t / E;
  const int64_t e = j < m ? t - j * E : E;
  if (e >= E) return;
  float gl[K1][DIM];
#pragma unroll
  for (int k = 0; k < K1; ++k)
#pragma unroll
    for (int b = 0; b < DIM; ++b) gl[k][b] = __ldg(g + (k * DIM + b) * E + e);
  const float v = __ldg(vol + e);
  const float* u_e = ue + e * s.e + j * s.j;
  float* f_e = fe + e * s.e + j * s.j;
  qp_element<DIM, NN, Q, CFG, 1>(
      gl, v, lam, mu,
      [&](int, int c, int i) { return __ldg(u_e + i * s.a + c * s.c); },
      [&](int, int c, int i, float x) { f_e[i * s.a + c * s.c] = x; });
}

// Columns a lane computes at m columns: 2 at m = 6, where a lane per
// column would compute every shape gradient six times; else 1.
__host__ __device__ constexpr int columns_per_lane(int m) {
  return m == 6 ? 2 : 1;
}

// Elements in one warp's tile: one lane per (element, CPT columns) of
// them, rounded down so that the tile's te P floats (P = n d m) are whole
// 16-byte units; 0 where no tile is (odd P and more than 16 lanes an
// element): the direct path runs those.
__host__ __device__ constexpr int tile_elements(int m, int cpt, int P) {
  const int unit = P % 4 == 0 ? 1 : P % 2 == 0 ? 2 : 4;
  return (32 / (m / cpt)) / unit * unit;
}

// Shared memory of the pipelined path: per warp kStages stages, each the
// rows of a tile (te P <= 32 n d CPT floats) and its g and vol ([K1 d +
// 1][32], one column an element), then the warps' mbarriers, one a stage.
template <int DIM, int NN, int CPT>
struct Ring {
  static constexpr int kGV = (DIM + 1) * DIM + 1;
  static constexpr int kRowF = 32 * NN * DIM * CPT;
  static constexpr int kStageF = kRowF + kGV * 32;   // 128-byte multiple
  static constexpr int kWarpF = kStages * kStageF;
  static constexpr int kBytes = kWarps * (kWarpF * 4 + kStages * 8);
};

// The pipelined path for element-major node rows, m <= 32 columns (M > 0:
// m at compile time; 0: at run time), CPT columns a lane, te > 0, ue and
// fe 16-byte aligned.
template <int DIM, int NN, int Q, int CFG, int M, int CPT>
__global__ void __launch_bounds__(kThreads, CPT == 1 ? 3 : 2)
qp_rows_kernel(const float* __restrict__ g, const float* __restrict__ vol,
               const float* __restrict__ ue, float* __restrict__ fe,
               float lam, float mu, int64_t E, int m_rt) {
  using R = Ring<DIM, NN, CPT>;
  constexpr int K1 = DIM + 1;
  const int m = M > 0 ? M : m_rt;
  const int P = NN * DIM * m;
  const int lanes = m / CPT;                 // lanes an element
  const int te = tile_elements(m, CPT, P);
  const uint32_t tile_bytes = static_cast<uint32_t>(te * P) * 4u;
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const ring = smem + warp * R::kWarpF;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + kWarps * R::kWarpF)
                         + warp * kStages;
  const int64_t tiles = (E + te - 1) / te;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t count = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;
  const int q = lane / lanes;                // this lane's element
  const int j = (lane - q * lanes) * CPT;    // and its first column
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bulk_async::mbar_init(bars + s);
    bulk_async::mbar_init_fence();
  }
  __syncwarp();

  // Start the copies of this warp's k-th tile into stage k % kStages: its
  // rows in one bulk copy (a full tile; a partial one is copied at its
  // turn), its g and vol by the lanes; one cp.async group a call.
  auto issue = [&](int64_t k) {
    const int64_t e0 = (first + k * stride) * te;
    const int ne = static_cast<int>(E - e0 < te ? E - e0 : te);
    float* const stage = ring + (k % kStages) * R::kStageF;
    if (ne == te && lane == 0)
      bulk_async::load(stage, ue + e0 * P, tile_bytes, bars + k % kStages);
    if (lane < ne) {
      float* const gv = stage + R::kRowF + lane;
#pragma unroll
      for (int r = 0; r < R::kGV - 1; ++r)
        __pipeline_memcpy_async(gv + r * 32, g + r * E + e0 + lane,
                                sizeof(float));
      __pipeline_memcpy_async(gv + (R::kGV - 1) * 32, vol + e0 + lane,
                              sizeof(float));
    }
    __pipeline_commit();
  };
  for (int64_t k = 0; k < kStages - 1; ++k) {
    if (k < count) {
      issue(k);
    } else {
      __pipeline_commit();
    }
  }

  for (int64_t k = 0; k < count; ++k) {
    const int s = static_cast<int>(k % kStages);
    const int64_t e0 = (first + k * stride) * te;
    const int ne = static_cast<int>(E - e0 < te ? E - e0 : te);
    float* const stage = ring + s * R::kStageF;
    __pipeline_wait_prior(kStages - 2);     // this tile's g and vol
    if (ne < te) {                          // the partial last tile
      for (int f = lane; f < ne * P; f += 32) stage[f] = __ldg(ue + e0 * P + f);
    }
    __syncwarp();
    if (ne == te)
      bulk_async::wait(bars + s, static_cast<uint32_t>(k / kStages) & 1u);
    if (q < ne) {
      const float* const gv = stage + R::kRowF + q;
      float gl[K1][DIM];
#pragma unroll
      for (int kk = 0; kk < K1; ++kk)
#pragma unroll
        for (int b = 0; b < DIM; ++b) gl[kk][b] = gv[(kk * DIM + b) * 32];
      const float v = gv[(R::kGV - 1) * 32];
      float* const col = stage + q * P + j;
      qp_element<DIM, NN, Q, CFG, CPT>(
          gl, v, lam, mu,
          [&](int cc, int c, int i) { return col[(i * DIM + c) * m + cc]; },
          [&](int cc, int c, int i, float x) {
            col[(i * DIM + c) * m + cc] = x;
          });
    }
    bulk_async::fence_shared();
    __syncwarp();
    if (ne < te) {
      for (int f = lane; f < ne * P; f += 32) __stcs(fe + e0 * P + f, stage[f]);
    } else if (lane == 0) {
      bulk_async::store(fe + e0 * P, stage, tile_bytes);
    }
    // Refill the stage of tile k - 1 with tile k + kStages - 1 once its
    // store has read it (the store of tile k may still run).  A partial
    // tile is the grid's last, so nothing follows it.
    const int64_t next = k + kStages - 1;
    if (next < count) {
      if (lane == 0) bulk_async::wait_read<1>();
      __syncwarp();
      issue(next);
    } else {
      __pipeline_commit();
    }
  }
  if (lane == 0) bulk_async::wait_all();
}

template <int DIM, int NN, int Q, int CFG, int M, int CPT = 1>
int launch_rows(const float* g, const float* vol, const float* ue, float* fe,
                float lam, float mu, int64_t E, int m, cudaStream_t stream) {
  using R = Ring<DIM, NN, CPT>;
  auto kernel = qp_rows_kernel<DIM, NN, Q, CFG, M, CPT>;
  // blocks resident at once on each device, worked out (with the shared-
  // memory limit raised) at the first launch there; 0 = not yet
  static std::atomic<int> resident_on[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int resident = resident_on[dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R::kBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, R::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    resident_on[dev].store(resident, std::memory_order_relaxed);
  }
  const int te = tile_elements(m, CPT, NN * DIM * m);
  const int64_t tiles = (E + te - 1) / te;
  const int64_t wanted = (tiles + kWarps - 1) / kWarps;
  const unsigned blocks =
      static_cast<unsigned>(wanted < resident ? wanted : resident);
  kernel<<<blocks, kThreads, R::kBytes, stream>>>(g, vol, ue, fe, lam, mu, E,
                                                  m);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM, int NN, int Q, int CFG>
int launch(const void* g_, const void* vol_, const void* ue_, void* fe_,
           float lam, float mu, int64_t E, int m, Strides s,
           cudaStream_t stream) {
  const auto* g = static_cast<const float*>(g_);
  const auto* vol = static_cast<const float*>(vol_);
  const auto* ue = static_cast<const float*>(ue_);
  auto* fe = static_cast<float*>(fe_);
  const int P = DIM * NN * m;
  const bool aligned = (reinterpret_cast<uintptr_t>(ue) % 16 == 0)
                       && (reinterpret_cast<uintptr_t>(fe) % 16 == 0);
  if (s.e == P && s.a == DIM * m && s.c == m && s.j == 1 && m <= 32
      && tile_elements(m, columns_per_lane(m), P) > 0 && aligned) {
    switch (m) {
      case 1:
        return launch_rows<DIM, NN, Q, CFG, 1>(g, vol, ue, fe, lam, mu, E, m,
                                               stream);
      case 3:
        return launch_rows<DIM, NN, Q, CFG, 3>(g, vol, ue, fe, lam, mu, E, m,
                                               stream);
      case 6:
        return launch_rows<DIM, NN, Q, CFG, 6, columns_per_lane(6)>(
            g, vol, ue, fe, lam, mu, E, m, stream);
      default:
        return launch_rows<DIM, NN, Q, CFG, 0>(g, vol, ue, fe, lam, mu, E, m,
                                               stream);
    }
  }
  const int threads = kThreads;
  const int64_t blocks = (E * m + threads - 1) / threads;
  qp_direct_kernel<DIM, NN, Q, CFG><<<static_cast<unsigned>(blocks), threads,
                                      0, stream>>>(g, vol, ue, fe, lam, mu, E,
                                                   m, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  ue and fe
// share the strides (s_e, s_a, s_c, s_j) and m columns; element-major rows
// (s_e = n d m, s_a = d m, s_c = m, s_j = 1) take the pipelined kernel.
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
