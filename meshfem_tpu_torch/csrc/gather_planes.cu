// Kernel A: the routed gather slot <- node, in two output layouts.
//
//   planes mode: out[p, s] = ids[s] >= 0 ? src[p, ids[s]] : 0     [P, S]
//   rows mode:   out[s, p] = ids[s] >= 0 ? src(ids[s], p) : 0     [S, P]
//
// with src(i, p) = src[i * node_stride + p * plane_stride], so one rows
// kernel reads node rows [N, P] (node stride P, plane stride 1) and
// component planes [P, N] (node stride 1, plane stride N) without a copy.
//
// Replaces meshfem_tpu/sparse/route.py::_copy_kernel_p (:139, planes mode)
// and ::_copy_kernel (:187, one plane): the routed gather of every
// RoutedEBE apply.  The TPU kernels route 128-lane windows through chain
// buckets because Mosaic's gather cannot cross lanes; a Hopper thread loads
// any address, so the whole plan set reduces to one int32 index per slot.
//
// Bound on the H100: memory.  A call moves ids (4 B a slot), the source
// (4 B a node and plane) and the output (4 B a slot and plane): at the
// block apply's 18 planes on the periodic cell (2,482,200 slots, 335,161
// nodes) ~213 MB, 0.064 ms at 3.35 TB/s, of which the output is 179 MB.
//
// Planes mode (kernels C and D read [P, n*E], slots element-fastest,
// s = a * E + e): one thread per slot reads its index once and loops over
// the planes; neighbouring threads write neighbouring addresses.  Its source
// reads are one 4-byte value per 32-byte sector and plane: P sectors a slot.
//
// Rows mode (the dense applies; slots element-major, s = e * n + a, so
// [S, P] is the bmm operand [E, n*d, m] under the node-major Ke).  The
// output is written in order, with streaming stores (__stcs, evict-first),
// so the 179 MB output stream does not push the source rows (24 MB at 18
// planes, 4.7 MB at 3) out of the 50 MB L2, where the repeated reads of a
// node shared by neighbouring elements hit.  Two mappings:
//   - node rows in, P even (the block apply's 18 values a node): the flat
//     [S, P] output in 16-byte pieces of 4 values.  A piece's two 8-byte
//     halves each lie inside one source row (P and the offset are even),
//     so a warp reads whole 72-byte rows (3 sectors where the planes
//     layout read 18) in 8-byte pieces, and writes 512 contiguous bytes a
//     step.  16-byte source pieces would need P % 4 == 0, which 18 is
//     not; a mapping of floor(32 / P) rows a warp would leave 14 of 32
//     lanes idle at 18 planes.  A thread writes two pieces, 256 apart,
//     and issues all their index and source loads before its first store:
//     with one piece a thread the kernel's time varied from run to run
//     and at its worst drew level with index_select; four pieces were no
//     faster than two;
//   - planes in (apply_planes: the CG's [d, N] vectors), or odd P: a thread
//     takes 4 slots, blockDim apart (fewer threads a block for wide P, so
//     the tile stays within 48 KB), reads their indices, then their values
//     (at P = 3 all 12 loads before the first store; otherwise plane by
//     plane, 4 in flight) into a shared-memory tile [slots of the
//     block][P]; the block then writes its tile, a contiguous stretch of
//     the output, in 16-byte stores.  With d = 3 planes in, a slot's three
//     values lie in three sectors whatever the mapping; the tile keeps the
//     stores whole.  One slot a thread, or a runtime plane loop at P = 3,
//     was slower than index_select on the [N, 3] rows.

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

// Node rows in, P even, n_slots * P % 4 == 0, node stride even, plane
// stride 1: a block writes kQuads * 256 consecutive quads of the flat
// output; thread t of it writes quads t, t + 256, ...  Each quad is two
// 8-byte halves of source rows.  All of a thread's index and source loads
// are issued before its first store.
constexpr int kQuads = 2;

__global__ void __launch_bounds__(256)
gather_rows_vec4_kernel(const float* __restrict__ src,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, uint32_t planes,
                        int64_t node_stride, uint32_t n_quads) {
  const uint32_t base = blockIdx.x * 256 * kQuads + threadIdx.x;
  float2 h[kQuads][2];
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const uint32_t t = base + u * 256;
    const uint32_t f = 4 * (t < n_quads ? t : 0);
    uint32_t s = f / planes;
    uint32_t p = f - s * planes;                   // even
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int32_t id = __ldg(ids + s);
      h[u][i] = id >= 0 ? __ldg(reinterpret_cast<const float2*>(
                              src + id * node_stride + p))
                        : make_float2(0.0f, 0.0f);
      p += 2;
      if (p == planes) {
        p = 0;
        ++s;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const uint32_t t = base + u * 256;
    if (t < n_quads) {
      __stcs(reinterpret_cast<float4*>(out) + t,
             make_float4(h[u][0].x, h[u][0].y, h[u][1].x, h[u][1].y));
    }
  }
}

// Any source strides: kSlots slots a thread into a shared tile
// [kSlots * blockDim][P], then the block's contiguous output stretch in
// float4 stores (s0 * P is a multiple of 4: kSlots is).  PC: the plane
// count as a compile-time constant (3, the CG's [d, N] vectors), so all
// kSlots * PC loads are issued before the first store; 0 for a runtime
// count, loaded plane by plane.
constexpr int kSlots = 4;

template <int PC>
__global__ void gather_rows_tile_kernel(const float* __restrict__ src,
                                        const int32_t* __restrict__ ids,
                                        float* __restrict__ out,
                                        int planes_rt, int64_t node_stride,
                                        int64_t plane_stride,
                                        int64_t n_slots) {
  extern __shared__ __align__(16) float tile[];
  const int planes = PC > 0 ? PC : planes_rt;
  const int per_block = kSlots * blockDim.x;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * per_block;
  int32_t id[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int64_t s = s0 + u * blockDim.x + threadIdx.x;
    id[u] = s < n_slots ? __ldg(ids + s) : -1;
  }
  if constexpr (PC > 0) {
    float x[kSlots][PC];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        x[u][p] = id[u] >= 0
                      ? __ldg(src + id[u] * node_stride + p * plane_stride)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        tile[(u * blockDim.x + threadIdx.x) * PC + p] = x[u][p];
      }
    }
  } else {
    for (int p = 0; p < planes; ++p) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        tile[(u * blockDim.x + threadIdx.x) * planes + p] =
            id[u] >= 0 ? __ldg(src + id[u] * node_stride + p * plane_stride)
                       : 0.0f;
      }
    }
  }
  __syncthreads();
  const int64_t rest = n_slots - s0;
  const int n_here =
      static_cast<int>(rest < per_block ? rest : per_block) * planes;
  float* dst = out + s0 * planes;
  const int n4 = n_here / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    __stcs(reinterpret_cast<float4*>(dst) + i,
           reinterpret_cast<const float4*>(tile)[i]);
  }
  for (int i = 4 * n4 + threadIdx.x; i < n_here; i += blockDim.x) {
    __stcs(dst + i, tile[i]);
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

// The caller guarantees n_slots * planes < 2^31 and planes <= 384, and,
// for the vec4 mapping, plane stride 1 with even planes and node stride,
// n_slots * planes % 4 == 0 and an 8-byte aligned source.
extern "C" int gather_rows_f32(const void* src, const void* ids, void* out,
                               int planes, int64_t node_stride,
                               int64_t plane_stride, int64_t n_slots,
                               int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  if (n_slots > 0 && vec4) {
    const uint32_t n_quads =
        static_cast<uint32_t>(n_slots * planes / 4);
    const uint32_t per_block = 256 * kQuads;
    gather_rows_vec4_kernel<<<(n_quads + per_block - 1) / per_block, 256, 0,
                              st>>>(s, i, o, static_cast<uint32_t>(planes),
                                    node_stride, n_quads);
  } else if (n_slots > 0) {
    // 256 threads a block up to 12 planes (48 KB of tile), fewer above
    int threads = 256;
    while (threads > 32 && threads * kSlots * planes > 12288) threads /= 2;
    const size_t smem =
        static_cast<size_t>(threads) * kSlots * planes * sizeof(float);
    const auto kernel = planes == 3 ? gather_rows_tile_kernel<3>
                                    : gather_rows_tile_kernel<0>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int per_block = threads * kSlots;
    const unsigned blocks =
        static_cast<unsigned>((n_slots + per_block - 1) / per_block);
    kernel<<<blocks, threads, smem, st>>>(
        s, i, o, planes, node_stride, plane_stride, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
