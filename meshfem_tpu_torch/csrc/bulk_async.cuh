// Hopper's bulk asynchronous copies and transaction barriers, for kernel C.
//
// cp.async.bulk moves one contiguous stretch (a multiple of 16 bytes, both
// ends 16-byte aligned) between device and shared memory on the copy
// engine: one thread issues it and no register holds the data.  A load
// reports its bytes to an mbarrier in shared memory, which the consumers
// wait on by phase parity; a store is tracked in bulk groups of the issuing
// thread, which it waits on before it reuses the shared buffer.  Shared
// memory written by threads (the generic proxy) is made visible to a bulk
// store (the async proxy) by fence.proxy.async.shared::cta before the
// barrier that precedes the store.

#pragma once

#include <cstdint>

namespace bulk_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival (the issuing thread's expect_tx) completes a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// After mbar_init, before the barrier is used by the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy ``bytes`` from device memory ``src`` to shared ``dst``; the phase
// of ``bar`` completes when they have landed.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Order this thread's shared-memory writes before a later bulk store.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy ``bytes`` from shared ``src`` to device memory ``dst`` and close the
// bulk group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (their source may then be overwritten).
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Wait until every bulk group of this thread has completed.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace bulk_async
