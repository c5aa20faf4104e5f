// Kernel E: element_stiffness — float32 element-stiffness assembly of a
// constant material
//
//   Ke[e, (i,c), (j,f)] = vol_e sum_{k,l,a,b} g_ka g_lb T[k,l,i,j] C[c,a,f,b]
//
// (= vol_e (g_e (x) g_e) @ M with M[(k,a,l,b),(i,c,j,f)] = T[k,l,i,j]
// C[c,a,f,b], ops/element_matrices.fused_matrix_for), with g_e =
// grad_lambda[e] [K1, d], T the gradgrad table [K1, K1, n, n] and C the
// full material tensor [d, d, d, d]; dofs interleaved, row i d + c.
//
// Replaces meshfem_tpu/kernels/element_stiffness.py::_asm_kernel (:42), the
// float32 drop-in for element_elasticity_fused_apply.  The TPU kernel pads
// (n d)^2 = 900 to 1024 lanes, passes the volume as a [BE, 1] block and
// builds the Gram block by lane concatenation for ONE matrix-unit product
// with M (144 x 900 multiply-adds an element); none of that is carried over.
//
// Bound on the H100: memory, ~0.30 ms for the 1.0 GB of Ke it writes at the
// bench size (E = 279,936, P2 tets) at 3.35 TB/s.  The kernel contracts
// the material first and the table second:
//
//   H[k,l,c,f]      = sum_ab g_ka g_lb C[c,a,f,b]            (9 terms)
//   Ke[(i,c),(j,f)] = vol sum_kl T[k,l,i,j] H[k,l,c,f]        (16 terms)
//
// ~15.3k multiply-adds an element (H's 10 distinct blocks k <= l, since
// H[k,l,c,f] = H[l,k,f,c] for a symmetric D, which the wrapper checks, and
// 900 x 16 for Ke).
//
// Route: FP64 FMA on the CUDA cores, rounded once to float32 per entry.
// Not FP32, because the first version of this kernel summed in float32
// and the dense clamped solve then took 5 refinement rounds and 5,225
// inner CG iterations (4,099 with the TPU kernel's one product, 3,838 with
// the float64 Ke cast to float32; H100, 700 W).  The 16-term sum cancels
// (sum_l g_l = 0), and every element of a kind makes the same rounding, so
// the error does not average out: it breaks the rigid-body modes the soft
// end of the spectrum feels, and each refinement round reduces the
// residual less.  Summed in float64, Ke is the float64 Ke cast to float32
// to within an ulp.  Not 3xTF32 tensor cores either: the store bounds the
// kernel, and the FP64 pipe (~17 T multiply-adds/s, 0.24 ms for the bench
// size's 4.0 G) keeps the arithmetic under it without a split operand.
//
// What held the first Hopper version back, and what this design does about
// it:
// * its one product did 129.6k multiply-adds an element (~1.08 ms of FP32
//   arithmetic at the bench size, 3.5x the store): the material-first
//   contraction does 15.3k;
// * M (518 KB) did not fit in shared memory, so each block re-read a column
//   tile of it: T (12.8 KB in float64) sits in shared memory for the life
//   of a block, and C (81 doubles) in the launch's parameters, whose
//   constant bank the multiply-adds read as operands, with no load.
//
// Work unit: one warp owns 32 consecutive lanes t = (e n + i) JS + jh
// (JS = 2 at P2: a lane takes half of the n nodes j).  The pair (e, i)
// writes rows i d .. i d + d - 1 of element e, the d (n d) floats of Ke at
// (e n + i) d (n d), so a warp's output is ONE contiguous run (32 / JS
// pairs, 5.6 KB at P2).  Per unit, with no block barrier:
// 1. the lanes compute H in float64 for the (at most 32 / (JS n) + 2)
//    elements the unit touches, one (element, k <= l) block each, into the
//    warp's shared memory (g read from device memory, C a parameter);
// 2. each lane accumulates its d x (n / JS) d outputs in float64 registers
//    (acc[j][c f] += T[k,l,i,j] H[k,l,c,f]; per (k, l) it reads n / JS table
//    values and d^2 H values, 16-byte loads, for (n / JS) d^2 FMAs);
// 3. the lanes scale by the volume, round to float32, stage the run in
//    shared memory and write it as 16-byte streaming stores (__stcs: Ke is
//    larger than L2), 512 consecutive bytes a warp instruction.
// Only __syncwarp orders the three steps, so one warp's stores overlap the
// others' arithmetic.  Four warps a block, three blocks an SM; T is copied
// in once per block, and a block walks many units.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

constexpr int round2(int x) { return (x + 1) / 2 * 2; }

template <int DIM, int NN>
struct Shape {
  static constexpr int K1 = DIM + 1;
  static constexpr int KK = K1 * K1;
  static constexpr int G = K1 * DIM;              // floats of g_e
  static constexpr int D2 = DIM * DIM;
  static constexpr int JS = NN > 4 ? 2 : 1;       // lanes sharing a row set
  static constexpr int JN = NN / JS;              // nodes j a lane covers
  static constexpr int JNP = round2(JN);          // its table row, in doubles
  static constexpr int HPD = round2(D2);          // one (k, l) block of H
  static constexpr int HS = KK * HPD + 2;         // one element's H (+4 banks)
  static constexpr int ND = NN * DIM;
  static constexpr int CH = DIM * ND;             // floats of one (e, i) pair
  static constexpr int PW = 32 / JS;              // pairs in a warp's unit
  static constexpr int EW = PW / NN + 2;          // elements a unit touches
  static constexpr int T_D = KK * NN * JS * JNP;  // table, doubles
  static constexpr int WARP_B = EW * HS * 8 + PW * CH * 4;
  static constexpr size_t SMEM = 8 * T_D + kWarps * WARP_B;
  static_assert(NN % JS == 0 && WARP_B % 16 == 0 && (EW * HS * 8) % 16 == 0,
                "16-byte aligned shared-memory regions");
};

// The material C[c, a, f, b], passed by value: the kernel reads it from the
// parameter bank at compile-time offsets, as multiply-add operands.
template <int DIM>
struct Material {
  double c[DIM * DIM * DIM * DIM];
};

// dst[0:N] = src[0:N], src 16-byte aligned shared memory
template <int N>
__device__ __forceinline__ void load_row(const double* src, double (&dst)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(src)[q];
    dst[2 * q] = v.x;
    dst[2 * q + 1] = v.y;
  }
  if constexpr (N % 2 == 1) dst[N - 1] = src[N - 1];
}

template <int DIM, int NN>
__global__ void __launch_bounds__(kThreads, 3)
element_stiffness_kernel(const float* __restrict__ gl,
                         const float* __restrict__ vol,
                         const double* __restrict__ T_g,
                         const Material<DIM> C, float* __restrict__ Ke,
                         int64_t E) {
  using Sh = Shape<DIM, NN>;
  constexpr int K1 = Sh::K1, KK = Sh::KK, D2 = Sh::D2, JS = Sh::JS;
  constexpr int JN = Sh::JN, JNP = Sh::JNP, HPD = Sh::HPD, HS = Sh::HS;
  constexpr int ND = Sh::ND, CH = Sh::CH, PW = Sh::PW;
  extern __shared__ double2 smem2[];
  double* sT = reinterpret_cast<double*>(smem2);   // [KK][NN][JS][JNP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  char* wbase = reinterpret_cast<char*>(sT + Sh::T_D) + warp * Sh::WARP_B;
  double* sH = reinterpret_cast<double*>(wbase);   // [EW][KK][HPD], stride HS
  float* sK = reinterpret_cast<float*>(wbase + Sh::EW * HS * 8);  // [PW][CH]

  for (int r = threadIdx.x; r < Sh::T_D; r += kThreads) {
    const int jj = r % JNP, row = r / JNP;         // row = (kl NN + i) JS + jh
    const int j = (row % JS) * JN + jj, kli = row / JS;
    sT[r] = jj < JN ? __ldg(T_g + kli * NN + j) : 0.0;
  }
  __syncthreads();

  const int64_t n_pairs = E * NN;
  for (int64_t t0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
       t0 < n_pairs * JS; t0 += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t p0 = t0 / JS;
    const int64_t p_end = p0 + PW < n_pairs ? p0 + PW : n_pairs;
    const int64_t e_first = p0 / NN;
    const int ne = static_cast<int>((p_end - 1) / NN - e_first) + 1;

    // 1. H[k,l,c,f] = sum_ab g_ka g_lb C[c,a,f,b] in float64, and its
    //    mirror H[l,k,f,c]
    for (int task = lane; task < ne * KK; task += 32) {
      const int el = task / KK, k = task % KK / K1, l = task % K1;
      if (k > l) continue;
      const float* ge = gl + (e_first + el) * Sh::G;
      double gg[D2];
#pragma unroll
      for (int a = 0; a < DIM; ++a)
#pragma unroll
        for (int b = 0; b < DIM; ++b)
          gg[a * DIM + b] = static_cast<double>(__ldg(ge + k * DIM + a))
                            * static_cast<double>(__ldg(ge + l * DIM + b));
      double* h = sH + el * HS;
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int f = 0; f < DIM; ++f) {
          double acc = 0.0;
#pragma unroll
          for (int a = 0; a < DIM; ++a)
#pragma unroll
            for (int b = 0; b < DIM; ++b)
              acc += C.c[((c * DIM + a) * DIM + f) * DIM + b] * gg[a * DIM + b];
          h[(k * K1 + l) * HPD + c * DIM + f] = acc;
          if (k != l) h[(l * K1 + k) * HPD + f * DIM + c] = acc;
        }
    }
    __syncwarp();

    // 2. this lane's block of Ke, float64: rows i DIM + c, columns of
    //    nodes jh JN .. jh JN + JN - 1; acc[j][c f] = sum_kl T[k,l,i,j]
    //    H[k,l,c,f]
    const int64_t t = t0 + lane;
    const int64_t p = t / JS;
    const int jh = static_cast<int>(t % JS);
    const int el = static_cast<int>(p / NN - e_first);
    const int i = static_cast<int>(p % NN);
    double acc[JN][D2];
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int cf = 0; cf < D2; ++cf) acc[j][cf] = 0.0;
#pragma unroll
    for (int kl = 0; kl < KK; ++kl) {
      double hv[D2], tv[JN];
      load_row<D2>(sH + el * HS + kl * HPD, hv);
      load_row<JN>(sT + ((kl * NN + i) * JS + jh) * JNP, tv);
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int cf = 0; cf < D2; ++cf) acc[j][cf] += tv[j] * hv[cf];
    }

    // 3. scale by the volume, round once to float32, stage the warp's run
    //    (pairs p0 .. p_end - 1 are CH floats each, contiguous in Ke) and
    //    stream it out
    const double v = p < n_pairs ? static_cast<double>(__ldg(vol + p / NN))
                                 : 0.0;
    float* dst = sK + (p - p0) * CH + jh * JN * DIM;
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int f = 0; f < DIM; ++f)
          dst[c * ND + j * DIM + f] = static_cast<float>(v * acc[j][c * DIM + f]);
    __syncwarp();
    const int n4 = static_cast<int>((p_end - p0) * CH / 4);
    float4* out = reinterpret_cast<float4*>(Ke + p0 * CH);
    const float4* src = reinterpret_cast<const float4*>(sK);
    for (int q = lane; q < n4; q += 32) __stcs(out + q, src[q]);
    __syncwarp();              // the next unit overwrites sH and sK
  }
}

template <int DIM, int NN>
int launch(const void* gl, const void* vol, const void* T, const double* C,
           void* Ke, int64_t E, cudaStream_t stream) {
  using Sh = Shape<DIM, NN>;
  Material<DIM> mat;
  for (int r = 0; r < DIM * DIM * DIM * DIM; ++r) mat.c[r] = C[r];
  auto kernel = element_stiffness_kernel<DIM, NN>;
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
                               static_cast<int>(Sh::SMEM));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, Sh::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    resident_on[dev].store(resident, std::memory_order_relaxed);
  }
  const int64_t units = (E * NN * Sh::JS + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(units < resident ? units : resident);
  kernel<<<blocks, kThreads, Sh::SMEM, stream>>>(
      static_cast<const float*>(gl), static_cast<const float*>(vol),
      static_cast<const double*>(T), mat, static_cast<float*>(Ke), E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cfg: (dim, deg) = 0 (3, 2), 1 (3, 1), 2 (2, 2), 3 (2, 1).  gl [E, K1, d]
// and vol [E] float32 and T the gradgrad table [K1, K1, n, n] float64, in
// device memory; C [d, d, d, d] float64 in HOST memory (copied into the
// launch's parameters) -> Ke [E, n d, n d] float32, 16-byte aligned.
extern "C" int element_stiffness_f32(int cfg, const void* gl, const void* vol,
                                     const void* T, const double* C, void* Ke,
                                     int64_t E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  switch (cfg) {
    case 0: return launch<3, 10>(gl, vol, T, C, Ke, E, s);
    case 1: return launch<3, 4>(gl, vol, T, C, Ke, E, s);
    case 2: return launch<2, 6>(gl, vol, T, C, Ke, E, s);
    case 3: return launch<2, 3>(gl, vol, T, C, Ke, E, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
