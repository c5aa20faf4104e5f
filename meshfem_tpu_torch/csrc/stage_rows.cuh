// Shared-memory staging of element-major node rows, for kernels C and D.
//
// In rows, element e's values are one stretch of P = n d m floats (value
// (a, c, j) at (a d + c) m + j), and a warp's elements e0 .. e0 + ne - 1
// own the contiguous stretch src[e0 P .. (e0 + ne) P).  The warp copies it
// into its own part of shared memory, row q at dst[q * Pp], computes from
// there with one lane per (element, column), each writing its forces over
// the values it has read, and copies the rows back.  Both copies move
// consecutive floats on consecutive lanes, so every access covers whole
// 32-byte sectors.  Each warp stages, waits and writes back on its own
// (__syncwarp, no block barrier), so while one warp waits for its rows the
// others compute, as in the planes layout, where each thread's loads are
// in flight together.
// Pp = P rounded up to m modulo 32 banks: lane t = q m + j reads value
// (a, c) of its column at q Pp + (a d + c) m + j, which is t + (a d + c) m
// modulo 32, so the warp's 32 lanes hit 32 distinct banks.  The copy in is
// 4-byte cp.async (no registers held, every load of the thread in flight
// before the one wait); the copy out uses streaming stores (evict-first),
// since nothing reads the forces again before kernel B.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace stage_rows {

// Shared floats of one staged row of P = n d m floats.
__host__ __device__ constexpr int padded(int P, int m) {
  return P + (((m - P) % 32) + 32) % 32;
}

// Elements a warp stages (m <= 32): one lane per (element, column).
__host__ __device__ constexpr int elements_per_warp(int m) { return 32 / m; }

// The flat index f of the stretch walks in steps of 32 lanes; its row q and
// offset r follow by a fixed carry, with no division per float.
__device__ __forceinline__ void copy_in(float* dst,
                                        const float* __restrict__ src,
                                        int count, int P, int Pp, int lane) {
  constexpr int T = 32;
  const int dq = T / P, dr = T - dq * P;
  int f = lane, q = f / P, r = f - q * P;
  for (; f < count; f += T) {
    __pipeline_memcpy_async(dst + q * Pp + r, src + f, sizeof(float));
    q += dq;
    r += dr;
    if (r >= P) {
      r -= P;
      ++q;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

__device__ __forceinline__ void copy_out(float* __restrict__ dst,
                                         const float* src, int count, int P,
                                         int Pp, int lane) {
  constexpr int T = 32;
  const int dq = T / P, dr = T - dq * P;
  int f = lane, q = f / P, r = f - q * P;
  for (; f < count; f += T) {
    __stcs(dst + f, src[q * Pp + r]);
    q += dq;
    r += dr;
    if (r >= P) {
      r -= P;
      ++q;
    }
  }
}

}  // namespace stage_rows
