// The asynchronous copies from device to shared memory that the kernels stage
// with, and the host's check of its source alignment: the 16-byte cp.async,
// and the bulk copy (TMA, one thread a tile) that completes on an mbarrier
// in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_copy {

// A 16-byte cp.async copy (it bypasses L1); both addresses on 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that `count` arrivals (and the bytes they expect) complete;
// one thread inits, then the whole CTA syncs before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// An arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A bulk copy of `bytes` (a multiple of 16) from device to shared memory,
// both addresses on 16 bytes, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier accesses of shared memory before later bulk
// copies into it (the copies write through the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace kmt_copy
